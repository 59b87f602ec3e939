"""The evaluator slice as a whole: the port's ``Evaluator`` on the CPU
against the JAX package's on the same synthetic PoseTrack fixture and the
same weights (random flax variables with non-trivial BatchNorm state; the
port reads them from a checkpoint written through the bridge), at the tiny
topology: dataset, padded eval loader (6 samples in batches of 4), eval step
with and without flip-test, decode with ``POST_PROCESS`` off (argmax) and on
(DARK), inverse affine, ``all_boxes``, ``img_path_map``, the poseval protocol.

Tolerances (f32 on both sides): predicted coordinates 0.05 px in image
pixels and maxvals 2e-4 absolute + 2e-4 relative, for the final and the
backbone heatmaps (the heatmaps agree to ~2e-4 of their scale,
``tests/test_torch_fami_pose.py``; a coordinate moves only where an argmax
or a gradient sign is decided by less than that). Under DARK the bound is
0.05 px times the larger of 1 and the Newton step's own length in pixels:
random-weight heatmaps are not Gaussians, and a near-singular Hessian
multiplies the heatmaps' 1e-4 differences by the step. AP tables are equal.
The device-crop inputs are held to 5e-3 on the 0..255 scale, the host-crop
inputs to 1e-6 after normalization. Auto-window picks the same D. Under
``TPU.INT8_EVAL`` each checkpoint's scales equal a fresh calibration of that
checkpoint on the same first batch, bit for bit (the same function on the
same inputs).
"""

import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from fami_pose_tpu.data import loader as jax_loader
from fami_pose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrack
from fami_pose_tpu.engine.evaluator import Evaluator as JaxEvaluator
from fami_pose_tpu.ops.heatmap import (
    dark_get_final_preds as jax_dark, get_final_preds as jax_argmax,
)
from fami_pose_torch.data.loader import IMAGENET_STD
from fami_pose_torch.engine.evaluator import Evaluator, check_supported
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.models.quant import calibrate, quant_scales
from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed
from fixtures import make_cfg, make_posetrack_fixture
from test_auto_window import _pin_offset_heads
from test_end_to_end import _write_gt_annolists
from torch_port_helpers import (
    flax_variables_from_port, make_port_cfg, random_variables,
    save_port_checkpoint, tiny_model_cfg,
)

KEYS = ["Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Fixture directory, GT annolists, and one set of flax variables."""
    root = str(tmp_path_factory.mktemp("evaluator"))
    _, img_dir = make_posetrack_fixture(root, n_videos=2, n_frames=3,
                                        people_per_frame=1)
    jcfg = make_cfg(osp.join(root, "json"), img_dir)
    annot_dir = _write_gt_annolists(root, img_dir, jcfg)
    return dict(root=root, img_dir=img_dir, annot_dir=annot_dir)


def _cfg(world, make, out, flip=False, post=False, **tpu):
    cfg = tiny_model_cfg(make(osp.join(world["root"], "json"),
                              world["img_dir"]),
                         osp.join(world["root"], out))
    cfg.VAL.ANNOT_DIR = world["annot_dir"]
    cfg.VAL.FLIP_VAL = flip
    cfg.VAL.POST_PROCESS = post
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    return cfg


@pytest.fixture(scope="module")
def variables(world):
    ev = JaxEvaluator(_cfg(world, make_cfg, "out_shapes"))
    out = random_variables(
        lambda k: ev.model.init(k, *ev._example, train=False), seed=3)
    # the raw (un-squashed) DCN masks compound through the four stages and
    # random weights push the final heatmaps to ~1e5; with the DCN kernels
    # at 0.3 of their draw the heatmaps stay O(10), as trained ones do, and
    # the absolute tolerances above mean what they say
    for i in range(1, 5):
        out["params"][f"dcn_{i}"]["kernel"] *= np.float32(0.3)
    return out


@pytest.fixture(scope="module")
def jax_runs(world, variables):
    """The JAX evaluator's flat predictions, boxes, path map and AP tables
    for flip x POST_PROCESS: one compiled eval step per flip setting, the
    decode swapped on the same evaluator."""
    runs = {}
    for flip in (False, True):
        ev = JaxEvaluator(_cfg(world, make_cfg, f"out_jax_{flip}", flip=flip))
        seen = []
        scored = ev.dataset.evaluate

        def spy(cfg, preds, out_dir, boxes, img_path_map, **kw):
            seen.append((preds.copy(), boxes.copy(), dict(img_path_map)))
            return scored(cfg, preds, out_dir, boxes, img_path_map, **kw)

        ev.dataset.evaluate = spy
        for post, decode in ((False, jax_argmax), (True, jax_dark)):
            ev._decode = decode
            del seen[:]
            tables = ev.eval_checkpoint(dict(variables))
            (final, boxes, path_map), (backbone, _, _) = seen
            runs[flip, post] = dict(final=final, backbone=backbone,
                                    boxes=boxes, path_map=path_map,
                                    tables=tables)
    return runs


def _port_run(world, variables, flip, post, name):
    cfg = _cfg(world, make_port_cfg, name, flip=flip, post=post)
    ev = Evaluator(cfg, device="cpu")
    path = save_port_checkpoint(ev.checkpoints_dir, 0, variables)
    results = ev.eval()
    assert list(results) == [path]
    return ev, results[path]


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("post", [False, True], ids=["argmax", "dark"])
def test_evaluator_matches_jax(world, variables, jax_runs, flip, post):
    ref = jax_runs[flip, post]
    ev, tables = _port_run(world, variables, flip, post,
                           f"out_port_{flip}_{post}")
    if post:  # the argmax decode of the same heatmaps: where DARK starts
        plain, _ = _port_run(world, variables, flip, False,
                             f"out_port_{flip}_start")
        starts = {"final": plain.all_preds, "backbone": plain.all_preds_bb}
    n = 6  # not a multiple of the batch of 4: the last batch is padded
    assert len(ev.dataset) == n and len(ev.loader) == 2
    assert ev.timings["samples"] == n and ev.timings["batches"] == 2
    assert ev.all_preds.shape == (n, 17, 3)

    # poseval's inputs: center, scale, area = prod(scale * 200), score
    np.testing.assert_array_equal(ev.all_boxes, ref["boxes"])
    np.testing.assert_allclose(ev.all_boxes[:, 4],
                               np.prod(ev.all_boxes[:, 2:4] * 200, axis=1),
                               rtol=1e-6)
    assert dict(ev.img_path_map) == ref["path_map"]
    assert list(ev.img_path_map) == list(ref["path_map"])

    for tag, got in (("final", ev.all_preds), ("backbone", ev.all_preds_bb)):
        want = ref[tag]
        np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=2e-4,
                                   atol=2e-4, err_msg=tag)
        err = np.abs(got[..., :2] - want[..., :2]).max(-1)
        tol = np.full_like(err, 0.05)
        if post:  # scale with the Newton step (see the module docstring)
            step = np.abs(want[..., :2] - starts[tag][..., :2]).max(-1)
            tol = 0.05 * np.maximum(1.0, step)
        assert (err <= tol).all(), (tag, float((err / tol).max()))
        if post:
            assert (tol <= 0.05).mean() > 0.2, tag

    for tag in ("final", "backbone"):
        name_value, mean = tables[tag]
        ref_nv, ref_mean = ref["tables"][tag]
        assert list(name_value) == KEYS
        assert dict(name_value) == dict(ref_nv) and mean == ref_mean
        assert np.isfinite(mean)


def test_predictions_lie_in_image_coordinates(world, variables):
    """Decoded (B, J, h, w) heatmaps, untransposed: predictions fall inside
    each sample's crop box (a copied NHWC transpose would scatter them)."""
    ev, _ = _port_run(world, variables, False, False, "out_port_coords")
    c, s = ev.all_boxes[:, None, 0:2], ev.all_boxes[:, None, 2:4] * 100.0
    slack = ev.all_boxes[:, None, 2:3] * 200.0 / 24
    xy = ev.all_preds[..., :2]
    assert ((xy >= c - s - slack) & (xy <= c + s + slack)).all()


@pytest.fixture(scope="module")
def window_evaluators(world):
    """One evaluator per side for the auto-window regimes."""
    kw = dict(DCN_AUTO_WINDOW=True, DCN_AUTO_WINDOW_MAX=8)
    jev = JaxEvaluator(_cfg(world, make_cfg, "out_win_jax", **kw))
    pev = Evaluator(_cfg(world, make_port_cfg, "out_win_port", **kw),
                    device="cpu")
    return jev, pev


@pytest.mark.parametrize("value,cap,want", [
    (0.3, 8, 1), (4.6, 8, 5), (4.6, 4, None), (-2.5, 8, 3)],
    ids=["collapsed", "hot", "beyond-cap", "negative"])
def test_auto_window_picks_the_same_window(window_evaluators, variables,
                                           value, cap, want):
    """Offset heads pinned to a constant: both sides measure |offset| before
    any clamp and pick the same D; past the cap both fall back to the exact
    mode (``None``), and the port's evaluator then runs it end to end."""
    jev, pev = window_evaluators
    pinned = jax.device_get(_pin_offset_heads(variables, value))
    jev.cfg.TPU.DCN_AUTO_WINDOW_MAX = cap
    pev.cfg.TPU.DCN_AUTO_WINDOW_MAX = cap
    jev._maybe_auto_window(pinned)
    assert jev.model.dcn_max_offset == want
    path = save_port_checkpoint(pev.checkpoints_dir, 0, pinned)
    results = pev.eval()  # loads, calibrates the window, scores
    assert pev.dcn_max_offset == want
    assert all(m.max_offset == want for m in
               (pev.model.dcn_1, pev.model.dcn_2, pev.model.dcn_3,
                pev.model.dcn_4))
    assert np.isfinite(results[path]["final"][1])


def test_auto_window_off_leaves_the_configured_window(world, variables):
    ev, _ = _port_run(world, variables, False, False, "out_port_static")
    assert ev.dcn_max_offset == 2


def test_auto_window_hooks_read_offsets_before_the_clamp(world, variables):
    """With a window of 2 configured and offsets of 4.6 px, a statistic
    taken after the clamp would read 2 and keep D = 2."""
    cfg = _cfg(world, make_port_cfg, "out_port_hooks", DCN_AUTO_WINDOW=True)
    ev = Evaluator(cfg, device="cpu")
    assert ev.dcn_max_offset == 2
    pinned = jax.device_get(_pin_offset_heads(variables, 4.6))
    save_port_checkpoint(ev.checkpoints_dir, 0, pinned)
    ev.eval()
    assert ev.dcn_max_offset == 5
    assert not any(m._forward_hooks for m in ev.model.modules())


def test_list_model_files_rules(world, variables, tmp_path):
    cfg = _cfg(world, make_port_cfg, "out_port_sweep")
    ckpt_dir = osp.join(cfg.OUTPUT_DIR, "checkpoints")
    assert Evaluator(cfg, device="cpu").list_model_files() == []
    paths = [save_port_checkpoint(ckpt_dir, e, variables) for e in (0, 2, 10)]
    # latest
    assert Evaluator(cfg, device="cpu").list_model_files() == [paths[2]]
    # every checkpoint >= an id, in epoch order
    assert Evaluator(cfg, device="cpu", from_checkpoint_id=2) \
        .list_model_files() == paths[1:]
    assert Evaluator(cfg, device="cpu", from_checkpoint_id=0) \
        .list_model_files() == paths
    # an explicit MODEL_FILE wins over both
    explicit = save_port_checkpoint(str(tmp_path), 7, variables)
    cfg.VAL.MODEL_FILE = explicit
    ev = Evaluator(cfg, device="cpu", from_checkpoint_id=0)
    assert ev.list_model_files() == [explicit]
    # the test phase reads cfg.TEST
    cfg.VAL.MODEL_FILE = ""
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.ANNOT_DIR = world["annot_dir"]
    cfg.TEST.MODEL_FILE = paths[0]
    ev = Evaluator(cfg, "test", device="cpu")
    assert ev.list_model_files() == [paths[0]] and ev.sub is cfg.TEST
    # load_variables gives the model's state_dict, and the reverse bridge
    # gives back the flax leaves it was written from
    sd = ev.load_variables(paths[0])
    assert set(sd) == set(ev.model.state_dict())
    back = flax_variables_from_port(sd)
    leaves = jax.tree_util.tree_leaves_with_path(back)
    want = dict(jax.tree_util.tree_leaves_with_path(
        {k: variables[k] for k in ("params", "batch_stats")}))
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        np.testing.assert_array_equal(leaf, want[path])


def test_eval_sweeps_every_listed_checkpoint(world, variables):
    cfg = _cfg(world, make_port_cfg, "out_port_two")
    ev = Evaluator(cfg, device="cpu", from_checkpoint_id=0)
    paths = [save_port_checkpoint(ev.checkpoints_dir, e, variables)
             for e in (0, 1)]
    results = ev.eval()
    assert list(results) == paths
    assert results[paths[0]] == results[paths[1]]
    for tag in ("final", "backbone"):
        assert os.listdir(osp.join(ev.output_dir, f"validate_{tag}_json"))


@pytest.mark.parametrize("key,value", [
    ("TPU.MESH_SHAPE", [2, 1]),
    ("TPU.MESH_SHAPE", [4]), ("DEBUG.VIS_SKELETON", True),
    ("DEBUG.VIS_BBOX", True)])
def test_unported_options_are_refused(world, key, value):
    """A mesh of 2 or 4 devices in one process raises the JAX package's
    ``ValueError`` (over several processes the evaluator runs:
    ``tests/test_torch_distributed_run.py``). The overlays are ported now:
    ``DEBUG.VIS_*`` is no longer refused (``tests/
    test_torch_visualization.py`` runs them)."""
    cfg = _cfg(world, make_port_cfg, "out_port_refused")
    section, name = key.split(".")
    setattr(getattr(cfg, section), name, value)
    if section == "DEBUG":
        check_supported(cfg)
        assert getattr(Evaluator(cfg, device="cpu").cfg.DEBUG, name)
        return
    error, match = ValueError, f"needs {value[0]} devices, have 1"
    with pytest.raises(error, match=match):
        check_supported(cfg)
    with pytest.raises(error, match=match):
        Evaluator(cfg, device="cpu")


def test_int8_evaluator_calibrates_each_checkpoint_before_the_window(
        world, variables, monkeypatch):
    """TPU.INT8_EVAL with the auto-window: each checkpoint is calibrated
    after it is loaded and before the window is chosen (the window's
    forwards run on the int8 model: every scale is set by then), with
    scales of its own, and scored to finite tables."""
    cfg = _cfg(world, make_port_cfg, "out_port_int8", INT8_EVAL=True,
               INT8_CALIB_BATCHES=1, DCN_AUTO_WINDOW=True)
    ev = Evaluator(cfg, device="cpu")
    assert ev.model.backbone_quant == "int8"
    order, seen, windows = [], [], []
    calib, window = ev._maybe_calibrate_int8, ev._maybe_auto_window

    def spy_calibrate():
        order.append("calibrate")
        # the head's int8 chains read the DCN output: the window in force
        # (the previous checkpoint's, as in the JAX evaluator) counts
        windows.append(ev.dcn_max_offset)
        calib()
        seen.append({k: v.clone() for k, v in quant_scales(ev.model).items()})

    def spy_window():
        order.append("window")
        assert all(v is not None for v in quant_scales(ev.model).values())
        window()

    monkeypatch.setattr(ev, "_maybe_calibrate_int8", spy_calibrate)
    monkeypatch.setattr(ev, "_maybe_auto_window", spy_window)
    other = jax.tree_util.tree_map(np.copy, variables)
    other["params"]["hrnet"]["stem_conv1"]["kernel"] *= np.float32(1.5)
    states = [variables, other]
    paths = [save_port_checkpoint(ev.checkpoints_dir, e, v)
             for e, v in enumerate(states)]
    ev.from_checkpoint_id = 0
    results = ev.eval()
    assert order == ["calibrate", "window"] * 2
    assert list(results) == paths
    for tables in results.values():
        for tag in ("final", "backbone"):
            assert np.isfinite(tables[tag][1])
    assert any(not torch.equal(seen[0][k], seen[1][k]) for k in seen[0])
    first = ev._prepare(next(iter(ev.loader)))
    for state, scales, d in zip(states, seen, windows):
        fresh = FAMIPose.from_config(cfg, phase="validate").eval()
        fresh.load_state_dict(state_dict_from_flax(state))
        for i in range(1, 5):
            getattr(fresh, f"dcn_{i}").max_offset = d
        want = calibrate(fresh, [first])
        assert list(want) == list(scales)
        assert all(torch.equal(want[k], scales[k]) for k in want)


def test_other_refusals_and_defaults(world):
    cfg = _cfg(world, make_port_cfg, "out_port_refused2")
    for mesh in ([-1, 1], [1, 1], [-1], [1]):
        cfg.TPU.MESH_SHAPE = mesh
        check_supported(cfg)  # one device, however it is written
    cfg.MODEL.NAME = "PoseWarper"
    with pytest.raises(KeyError, match="Unknown model"):
        Evaluator(cfg, device="cpu")
    cfg = _cfg(world, make_port_cfg, "out_port_refused2")
    cfg.CORE_FUNCTION = "SomethingElse"
    with pytest.raises(KeyError, match="core function"):
        Evaluator(cfg, device="cpu")
    cfg = _cfg(world, make_port_cfg, "out_port_refused2")
    cfg.DATASET.NAME = "NoSuchDataset"
    with pytest.raises(KeyError, match="DATASET registry"):
        Evaluator(cfg, device="cpu")


def test_prepare_matches_jax_on_both_branches(world):
    """Host-cropped uint8 batches (bitwise equal between the packages'
    datasets) normalize to 1e-6; raw windows under ``TPU.DEVICE_CROP`` go
    through the device crop, held to 5e-3 on the 0..255 scale."""
    before = deform_conv2d_windowed.launches
    for device_crop in (False, True):
        kw = dict(DEVICE_CROP=device_crop, DEVICE_CROP_CANVAS=[192, 192])
        jcfg = _cfg(world, make_cfg, "out_prep_jax", **kw)
        pev = Evaluator(_cfg(world, make_port_cfg, "out_prep_port", **kw),
                        device="cpu")
        raw_ref = next(iter(jax_loader.build_eval_loader(
            jcfg, JaxPoseTrack(jcfg, "validate"), num_devices=1)))
        raw = next(iter(pev.loader))
        assert ("crop_center" in raw) == device_crop
        for k in ("kf", "sup", "center", "scale"):
            np.testing.assert_array_equal(raw[k], raw_ref[k])
        kf, sup = pev._prepare(raw)
        if device_crop:
            np.testing.assert_array_equal(raw["crop_center"],
                                          raw_ref["crop_center"])
            kf_ref, sup_ref = jax_loader.prepare_eval_inputs_device_crop(
                raw_ref["kf"], raw_ref["sup"], raw_ref["crop_center"],
                raw_ref["scale"], raw_ref["rotation"], image_size=(96, 128))
            atol = 5e-3 / (255.0 * float(IMAGENET_STD.min()))
        else:
            kf_ref, sup_ref = jax_loader.prepare_eval_inputs(
                raw_ref["kf"], raw_ref["sup"])
            atol = 1e-6
        assert tuple(kf.shape) == (4, 3, 128, 96)
        assert tuple(sup.shape) == (4, 12, 128, 96)
        np.testing.assert_allclose(kf.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(kf_ref), atol=atol, rtol=0)
        np.testing.assert_allclose(sup.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(sup_ref), atol=atol, rtol=0)
    # CPU tensors run the plain versions: no kernel launch was counted
    assert deform_conv2d_windowed.launches == before


def test_device_crop_evaluator_runs_end_to_end(world, variables):
    cfg = _cfg(world, make_port_cfg, "out_port_devcrop", DEVICE_CROP=True,
               DEVICE_CROP_CANVAS=[192, 192])
    ev = Evaluator(cfg, device="cpu")
    path = save_port_checkpoint(ev.checkpoints_dir, 0, variables)
    host, _ = _port_run(world, variables, False, False, "out_port_hostcrop")
    results = ev.eval()
    assert np.isfinite(results[path]["final"][1])
    # the two crop paths see the same pixels to 5e-3 of 255: most argmaxes
    # agree, so the predictions mostly coincide
    same = np.abs(ev.all_preds[..., :2] - host.all_preds[..., :2]).max(-1) < 0.5
    assert same.mean() > 0.8
