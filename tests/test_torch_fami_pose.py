"""The port's FAMIPose eval path against the JAX package, end to end, on the
same weights (flax variables with non-trivial BatchNorm state, bridged with
``fami_pose_torch.models.bridge.state_dict_from_flax``) and the same numpy
inputs, at the tiny topology of ``tests/test_fami_pose_model.py``.

Tolerances (f32 on both sides; XLA and torch's CPU kernels sum in other
orders): the backbone heatmaps 2e-4 absolute + 2e-4 relative. The head's
activations grow to ~1e3 through four DCN stages on random weights, and the
two sides agree to ~3e-5 of that scale at every stage, so ``final_hm`` is
held to 2e-4 relative + 2e-4 of its largest magnitude (:func:`_close`).
Decoded keypoints: 1e-3 px.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.data.loader import prepare_eval_inputs_device_crop as jax_prepare
from fami_pose_tpu.engine.steps import make_eval_step as jax_make_eval_step
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.models.torch_remap import remap_fami_pose_state_dict
from fami_pose_tpu.ops.heatmap import get_final_preds as jax_get_final_preds
from fami_pose_tpu.utils.bbox import box2cs as jax_box2cs
from fami_pose_torch.config import get_cfg
from fami_pose_torch.config.node import CfgNode
from fami_pose_torch.engine.predictor import PosePredictor
from fami_pose_torch.engine.steps import make_eval_step
from fami_pose_torch.models.bridge import (
    calibrate_batch_norm, init_weights, state_dict_from_flax,
)
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.ops.heatmap import get_final_preds
from torch_port_helpers import nchw, nhwc, random_variables

TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(ref).max())))


JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4)


def _port_model(max_offset, state_dict=None):
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
                 feat_hw=(16, 16), dcn_offset_groups=4,
                 dcn_max_offset=max_offset, warp_max_shift=26)
    if state_dict is not None:
        m.load_state_dict(state_dict)
    return m.eval()


@pytest.fixture(scope="module")
def variables():
    m = JaxFAMIPose(**JAX_KW)
    kf = jnp.zeros((1, 64, 64, 3))
    sup = jnp.zeros((1, 64, 64, 12))
    return random_variables(lambda k: m.init(k, kf, sup, train=False), seed=7)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(3)
    return (rs.randn(2, 64, 64, 3).astype(np.float32),
            rs.randn(2, 64, 64, 12).astype(np.float32))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_bridge_round_trip_through_reference_remap(variables):
    """flax -> port state_dict -> the JAX package's reference-name remap ->
    flax gives back every leaf, bit for bit, and names nothing unmapped."""
    sd = state_dict_from_flax(variables)
    port = _port_model(2, sd)  # strict load: every port tensor is named
    params, stats, unmapped = remap_fami_pose_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}
    )
    assert unmapped == []
    back = {"params": params, "batch_stats": stats}
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg="/".join(path))


@pytest.mark.parametrize(
    "use_pallas,max_offset", [(False, 2), (False, None), (True, 1)],
    ids=["windowed-D2", "exact", "pallas-D1"],
)
def test_eval_forward_matches_jax(variables, inputs, use_pallas, max_offset):
    """final_hm and kf_bb_hm of the whole eval forward. With the Pallas DCN
    the JAX model also permutes the offset/mask channels at call time
    (DCN_AUX_CHANNEL_FIRST); the port reads the canonical order."""
    kf, sup = inputs
    m = JaxFAMIPose(dcn_max_offset=max_offset, use_pallas_dcn=use_pallas,
                    **JAX_KW)
    final, kf_bb = jax.jit(lambda v, a, b: m.apply(v, a, b, train=False))(
        variables, kf, sup
    )
    port = _port_model(max_offset, state_dict_from_flax(variables))
    with torch.no_grad():
        p_final, p_kf_bb = port(nchw(kf), nchw(sup))
    assert tuple(p_final.shape) == (2, 17, 16, 16)
    np.testing.assert_allclose(nhwc(p_kf_bb), np.asarray(kf_bb), **TOL)
    _close(nhwc(p_final), final)


def test_flip_eval_step_matches_jax(variables, inputs):
    kf, sup = inputs
    m = JaxFAMIPose(dcn_max_offset=2, **JAX_KW)
    final, kf_bb = jax_make_eval_step(m, flip_test=True)(variables, kf, sup)
    port = _port_model(2, state_dict_from_flax(variables))
    p_final, p_kf_bb = make_eval_step(port, flip_test=True)(nchw(kf), nchw(sup))
    assert p_final.dtype == torch.float32
    _close(nhwc(p_final), final)
    np.testing.assert_allclose(nhwc(p_kf_bb), np.asarray(kf_bb), **TOL)


def test_get_final_preds_matches_jax(rng):
    hm = rng.rand(3, 17, 16, 12).astype(np.float32)
    hm[0, 2] = -1.0  # a non-positive map decodes to (0, 0)
    center = np.array([[30, 40], [100, 50], [7, 9]], np.float32)
    scale = np.array([[0.4, 0.53], [1.0, 1.33], [0.2, 0.27]], np.float32)
    ref_p, ref_m = jax_get_final_preds(jnp.asarray(hm), center, scale)
    p, mv = get_final_preds(torch.from_numpy(hm), torch.from_numpy(center),
                            torch.from_numpy(scale))
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(ref_m))


def _tiny_cfg():
    cfg = get_cfg(types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["MODEL.IMAGE_SIZE", [64, 64], "MODEL.HEATMAP_SIZE", [16, 16],
              "TPU.COMPUTE_DTYPE", "float32", "TPU.DCN_MAX_OFFSET", 2,
              "TPU.DCN_OFFSET_GROUPS", 4],
    ))
    cfg.MODEL.EXTRA = CfgNode(TINY_EXTRA, new_allowed=True)
    return cfg


def test_pose_predictor_matches_jax_pipeline(variables):
    """PosePredictor (device crop, normalize, flip-test eval step, decode)
    against the same pipeline assembled from the JAX package's functions,
    on a synthetic clip with clamp-to-edge windows and two boxes a frame."""
    rs = np.random.RandomState(11)
    frames = rs.randint(0, 256, size=(5, 48, 60, 3)).astype(np.uint8)
    boxes = {i: [([5.0 + i, 4.0, 30.0, 36.0], 0.9),
                 ([20.0, 10.0 - i, 25.0, 30.0], 0.8)] for i in range(5)}
    cfg = _tiny_cfg()
    pred = PosePredictor(cfg, state_dict_from_flax(variables), device="cpu",
                         flip_test=True, batch_size=4)
    records = pred(frames, boxes)
    assert len(records) == 10

    m = JaxFAMIPose(dcn_max_offset=2, **JAX_KW)
    step = jax_make_eval_step(m, flip_test=True)
    for rec_i, (fi, (bbox, _)) in enumerate(
        (fi, b) for fi in range(5) for b in boxes[fi]
    ):
        c, s = jax_box2cs(bbox, 1.0, 1.25)
        win = [fi] + [min(max(j, 0), 4) for j in (fi - 2, fi - 1, fi + 1, fi + 2)]
        kf_raw = frames[win[0]][None]
        sup_raw = np.concatenate([frames[j] for j in win[1:]], axis=-1)[None]
        kf, sup = jax_prepare(kf_raw, sup_raw, c[None], s[None],
                              np.zeros(1, np.float32), (64, 64))
        final, _ = step(variables, kf, sup)
        p, mv = jax_get_final_preds(jnp.transpose(final, (0, 3, 1, 2)),
                                    c[None], s[None])
        got = np.asarray(records[rec_i]["keypoints"])
        assert records[rec_i]["frame"] == fi
        np.testing.assert_allclose(got[:, :2], np.asarray(p)[0], atol=1e-3, rtol=0)
        _close(got[:, 2:], np.asarray(mv)[0])


def test_config_merges_like_jax():
    """The port's config copy merges the flagship YAML (``_BASE_`` chain
    included) to the same tree as the JAX package's."""
    from fami_pose_tpu.config import get_cfg as jax_get_cfg

    args = types.SimpleNamespace(cfg="configs/posetrack17/fami_pose.yaml",
                                 opts=[], root_dir=".")
    assert get_cfg(args)._to_plain() == jax_get_cfg(args)._to_plain()


def test_from_config_reads_model_semantic_knobs():
    args = types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["TPU.WARP_IMPL", "slice", "TPU.DCN_MAX_OFFSET", 0],
    )
    m = FAMIPose.from_config(get_cfg(args))
    assert m.compute_dtype == torch.bfloat16
    assert m.warp_max_shift == 32 and m.dcn_1.max_offset is None
    assert m.num_sup == 4 and m.dcn_1.offset_groups == 12
    m = FAMIPose.from_config(get_cfg(types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".", opts=[])))
    assert m.warp_max_shift == 26 and m.dcn_1.max_offset == 4


def test_seeded_init_is_deterministic():
    a = init_weights(_port_model(2), seed=5).state_dict()
    b = init_weights(_port_model(2), seed=5).state_dict()
    c = init_weights(_port_model(2), seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dcn_1.weight"], c["dcn_1.weight"])


def test_calibrated_random_init_keeps_heatmaps_bounded():
    """Seeded weights with identity BatchNorm statistics blow the heatmaps
    up through the raw DCN masks; calibrated statistics keep them O(1)."""
    m = init_weights(_port_model(2), seed=0)
    rs = np.random.RandomState(5)
    kf = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32))
    sup = torch.from_numpy(rs.randn(2, 12, 64, 64).astype(np.float32))
    calibrate_batch_norm(m, kf, sup)
    bn = m.hrnet.bn1
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    with torch.no_grad():
        final, _ = m(kf, sup)
    assert torch.isfinite(final).all() and float(final.abs().max()) < 100.0


def test_demo_cli_writes_keypoints_json(tmp_path):
    """``python -m fami_pose_torch.demo`` on the CPU: frames from image
    files, boxes from json, the records of ``tools/demo.py``."""
    import json

    import cv2

    from fami_pose_torch.demo import main

    rs = np.random.RandomState(2)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(3):
        img = rs.randint(0, 256, size=(40, 52, 3)).astype(np.uint8)
        cv2.imwrite(str(frames_dir / f"{i:04d}.png"), img)
    boxes = tmp_path / "boxes.json"
    boxes.write_text(json.dumps([
        {"frame": "0001.png", "bbox": [4, 5, 30, 30], "score": 0.7},
        {"frame": 2, "bbox": [10, 2, 20, 33]},
    ]))
    out = tmp_path / "out"
    main(["--cfg", "configs/posetrack17/fami_pose.yaml",
          "--frames", str(frames_dir), "--boxes", str(boxes),
          "--out", str(out), "--device", "cpu",
          "MODEL.IMAGE_SIZE", "[32,32]", "MODEL.HEATMAP_SIZE", "[8,8]"])
    records = json.loads((out / "keypoints.json").read_text())
    assert [r["frame"] for r in records] == ["0001.png", "0002.png"]
    assert records[0]["bbox_score"] == 0.7 and records[1]["bbox_score"] == 1.0
    kp = np.asarray([r["keypoints"] for r in records])
    assert kp.shape == (2, 17, 3) and np.all(np.isfinite(kp))
