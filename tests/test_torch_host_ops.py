"""The port's copies of the JAX package's small helpers against the originals
on the same numpy inputs: box -> (center, scale), the affine crop geometry
(numpy host side and the batched torch version), flip-back, the ImageNet
normalization and the keypoint tables.

Tolerance: the affine matrices 1e-5 absolute + 2e-6 relative, a few f32
ulps of translations up to ~1e2 px (both sides compute in f32 in closed form;
XLA and torch round sin/cos and fuse the products differently); the
normalized crops 1e-4 (test_torch_warp's 5e-3 on 0..255 pixels, divided by
255 * std); everything else is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.data import keypoints as jax_keypoints
from fami_pose_tpu.data import video_dataset as jax_video
from fami_pose_tpu.data.loader import prepare_eval_inputs_device_crop as jax_prepare
from fami_pose_tpu.ops import affine as jax_affine
from fami_pose_tpu.ops import pose as jax_pose
from fami_pose_tpu.utils import bbox as jax_bbox
from fami_pose_torch.data import keypoints, loader
from fami_pose_torch.ops import affine, pose
from fami_pose_torch.utils import bbox

BOXES = [[10.0, 20.0, 50.0, 120.0], [0.0, 0.0, 300.0, 40.0],
         [5.5, 7.25, 33.0, 44.0], [1.0, 2.0, 3.0, 4.0]]


@pytest.mark.parametrize("aspect", [0.75, 1.0, 1.5])
@pytest.mark.parametrize("enlarge", [1.0, 1.25])
def test_box2cs_matches_jax(aspect, enlarge):
    for box in BOXES:
        c, s = bbox.box2cs(box, aspect, enlarge)
        jc, js = jax_bbox.box2cs(box, aspect, enlarge)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("inv", [0, 1])
def test_host_affine_matches_jax(dark, inv):
    host = affine.dark_get_affine_transform if dark else affine.get_affine_transform
    jax_host = (jax_affine.dark_get_affine_transform if dark
                else jax_affine.get_affine_transform)
    for rot in (0.0, 30.0, -45.0):
        for shift in ([0, 0], [0.1, -0.05]):
            args = (np.array([120.0, 80.0], np.float32),
                    np.array([0.8, 1.1], np.float32), rot, (288, 384),
                    np.array(shift, np.float32), inv)
            np.testing.assert_allclose(host(*args), jax_host(*args),
                                       atol=1e-5, rtol=2e-6)


@pytest.mark.parametrize("dark", [False, True])
def test_batched_affine_and_inverse_match_jax(rng, dark):
    center = (rng.rand(5, 2) * 300).astype(np.float32)
    scale = (rng.rand(5, 2) + 0.2).astype(np.float32)
    rot = (rng.rand(5) * 90 - 45).astype(np.float32)
    for inv in (False, True):
        got = affine.affine_matrix(torch.from_numpy(center), scale, rot,
                                   (72, 96), inv=inv, dark=dark)
        ref = jax_affine.affine_matrix(jnp.asarray(center), jnp.asarray(scale),
                                       jnp.asarray(rot), (72, 96), inv=inv,
                                       dark=dark)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=2e-6)
    fwd = affine.affine_matrix(torch.from_numpy(center), scale, rot, (72, 96),
                               dark=dark)
    pts = torch.from_numpy((rng.rand(5, 7, 2) * 50).astype(np.float32))
    back = affine.apply_affine(affine.apply_affine(pts, fwd),
                               affine.invert_affine(fwd))
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-3)


def test_flip_back_matches_jax(rng):
    hm = rng.randn(2, 17, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(
        pose.flip_back(torch.from_numpy(hm)).numpy(), jax_pose.flip_back(hm)
    )
    nhwc = np.ascontiguousarray(hm.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(
        pose.flip_back_nhwc(torch.from_numpy(nhwc)).numpy(),
        jax_pose.flip_back_nhwc(nhwc),
    )


def test_tables_match_jax():
    assert keypoints.COCO_FLIP_PAIRS == jax_keypoints.COCO_FLIP_PAIRS
    np.testing.assert_array_equal(loader.IMAGENET_MEAN, jax_video.IMAGENET_MEAN)
    np.testing.assert_array_equal(loader.IMAGENET_STD, jax_video.IMAGENET_STD)


def test_eval_inputs_device_crop_matches_jax(rng):
    """Crop + normalize of a key frame and two supporting frames."""
    kf = rng.randint(0, 256, size=(2, 40, 50, 3)).astype(np.uint8)
    sup = rng.randint(0, 256, size=(2, 40, 50, 6)).astype(np.uint8)
    center = np.array([[25, 20], [10, 30]], np.float32)
    scale = np.array([[0.2, 0.2], [0.15, 0.15]], np.float32)
    rot = np.zeros(2, np.float32)
    ref_kf, ref_sup = jax_prepare(kf, sup, center, scale, rot, (24, 24))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    got_kf, got_sup = loader.prepare_eval_inputs_device_crop(
        t(kf), t(sup), torch.from_numpy(center), torch.from_numpy(scale),
        torch.from_numpy(rot), (24, 24),
    )
    np.testing.assert_allclose(got_kf.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref_kf), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_sup.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref_sup), atol=1e-4, rtol=0)
