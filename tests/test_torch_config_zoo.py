"""The shipped YAML experiment configs through the port: each merges into
the port's config and builds the port's model, whose parameters carry the
JAX model's names and shapes once bridged (the counterpart of
``tests/test_config_zoo.py``); and the Sub-JHMDB configuration's model
(15 joints, ``DISTANCE: 2`` so 2 supporting frames) held against JAX's
on the same weights and inputs, at narrow HRNet widths.

The JAX models' parameter shapes come from ``jax.eval_shape`` (no init is
compiled). Tolerance of the forward (f32 on both sides; XLA and torch's CPU
kernels sum in other orders), as ``tests/test_torch_fami_pose.py``: the
backbone heatmaps 2e-4 absolute + relative; ``final_hm`` 2e-4 relative +
2e-4 of its largest magnitude.
"""

import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.config import get_cfg as jax_get_cfg
from fami_pose_tpu.models import build_model as jax_build_model
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_torch.config import get_cfg
from fami_pose_torch.data.jhmdb import JHMDB_FLIP_PAIRS
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.build import build_model
from torch_port_helpers import nchw, nhwc, random_variables

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
CONFIGS = ["configs/posetrack17/fami_pose.yaml",
           "configs/posetrack18/fami_pose.yaml",
           "configs/jhmdb/fami_pose.yaml"]
JHMDB = "configs/jhmdb/fami_pose.yaml"


def _args(rel, opts=None):
    return types.SimpleNamespace(cfg=osp.join(REPO, rel), root_dir=REPO,
                                 opts=opts, train=False, val=False,
                                 test=False)


def _jax_init_args(cfg, model):
    """The JAX model's init on zero frames of the config's input size, 2 *
    (DISTANCE - 1) supporting frames stacked on the channel axis."""
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    num_sup = 2 * (int(cfg.DISTANCE) - 1)

    def init(key):  # traced only: the zeros are never allocated
        return model.init(key, jnp.zeros((1, h, w, 3)),
                          jnp.zeros((1, h, w, 3 * num_sup)), train=False)

    return init, num_sup


def _zeros_of(shapes):
    """Zero arrays of a variables tree's shapes, as zero-stride views (no
    memory)."""
    if hasattr(shapes, "items"):
        return {k: _zeros_of(v) for k, v in shapes.items()}
    return np.broadcast_to(np.zeros((), np.float32), shapes.shape)


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_merges_and_builds_the_port_model(rel):
    cfg = get_cfg(_args(rel))
    jcfg = jax_get_cfg(_args(rel))
    assert cfg.MODEL.NAME == "FAMIPose"
    assert cfg.MODEL.EXTRA.STAGE4.NUM_CHANNELS[-1] == 384
    assert osp.isabs(cfg.DATASET.JSON_DIR)
    for key in ("DISTANCE",):
        assert cfg[key] == jcfg[key]
    for key in ("NUM_JOINTS", "IMAGE_SIZE", "HEATMAP_SIZE"):
        assert list(np.atleast_1d(cfg.MODEL[key])) == \
            list(np.atleast_1d(jcfg.MODEL[key]))

    model = build_model(cfg, "train")
    jmodel = jax_build_model(jcfg, "train")
    init, num_sup = _jax_init_args(jcfg, jmodel)
    assert model.num_sup == num_sup
    assert model.hrnet.final_layer.weight.shape[0] == jmodel.num_joints \
        == int(cfg.MODEL.NUM_JOINTS)
    assert model.compute_dtype == torch.bfloat16 and \
        jmodel.dtype == jnp.bfloat16
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape)
            for k, v in state_dict_from_flax(_zeros_of(shapes)).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def _jhmdb_cfgs():
    """The Sub-JHMDB config at narrow widths (TINY_EXTRA, 4 offset groups,
    64x64 input, 16x16 heatmaps), f32, the plain windowed DCN on the JAX
    side (the port's CPU path is the same function)."""
    opts = ["MODEL.IMAGE_SIZE", "[64, 64]", "MODEL.HEATMAP_SIZE", "[16, 16]",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS_DCN", "False",
            "TPU.DCN_OFFSET_GROUPS", "4"]
    cfgs = get_cfg(_args(JHMDB, opts)), jax_get_cfg(_args(JHMDB, opts))
    for cfg in cfgs:
        cfg.MODEL.EXTRA = TINY_EXTRA
    return cfgs


def test_jhmdb_forward_matches_jax():
    """The Sub-JHMDB model's eval forward, and its flip-tested heatmaps
    averaged with ``JHMDB_FLIP_PAIRS`` swapped back, against JAX's on the
    same seeded weights and frames."""
    cfg, jcfg = _jhmdb_cfgs()
    jmodel = jax_build_model(jcfg, "validate")
    init, num_sup = _jax_init_args(jcfg, jmodel)
    assert num_sup == 2 and jmodel.num_joints == 15
    variables = random_variables(init, seed=5)
    model = build_model(cfg, "validate")
    model.load_state_dict(state_dict_from_flax(variables))
    model.eval()
    rs = np.random.RandomState(6)
    kf = rs.randn(2, 64, 64, 3).astype(np.float32)
    sup = rs.randn(2, 64, 64, 3 * num_sup).astype(np.float32)
    flip = lambda a: a[:, :, ::-1]  # noqa: E731  (NHWC width axis)
    both = (np.concatenate([kf, flip(kf)]), np.concatenate([sup, flip(sup)]))
    final, kf_bb = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False))(variables, *both)
    with torch.no_grad():
        p_final, p_kf_bb = model(nchw(both[0]), nchw(both[1]))
    assert tuple(p_final.shape) == (4, 15, 16, 16)
    np.testing.assert_allclose(nhwc(p_kf_bb), np.asarray(kf_bb), rtol=2e-4,
                               atol=2e-4)
    ref = np.asarray(final)
    got = nhwc(p_final)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * scale)

    def flip_test(hm):
        back = hm[2:, :, ::-1].copy()
        for a, b in JHMDB_FLIP_PAIRS:
            back[..., [a, b]] = back[..., [b, a]]
        return (hm[:2] + back) / 2

    np.testing.assert_allclose(flip_test(got), flip_test(ref), rtol=2e-4,
                               atol=2e-4 * scale)
