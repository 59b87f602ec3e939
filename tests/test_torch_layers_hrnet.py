"""The port's layers and HRNet (NCHW, ``fami_pose_torch.models``) against the
flax modules in eval mode, on bridged weights with non-trivial BatchNorm
running statistics.

Tolerance: 1e-4 absolute + 1e-4 relative in f32 (the same weights, conv
sums taken in another order by XLA and by torch's CPU kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.models import hrnet as jax_hrnet
from fami_pose_tpu.models import layers as jax_layers
from fami_pose_torch.models import layers
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.hrnet import HRNet, TINY_EXTRA
from torch_port_helpers import nchw, nhwc, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def _hrnet_state_dict(variables):
    """Bridge a bare flax HRNet: nest it the way FAMIPose holds it (backbone
    under ``hrnet``, heatmap head at the top) and strip the prefix."""
    params = dict(variables["params"])
    tree = {
        "params": {"final_layer": params.pop("final_layer"), "hrnet": params},
        "batch_stats": {"hrnet": variables["batch_stats"]},
    }
    return {k[len("hrnet."):]: v for k, v in state_dict_from_flax(tree).items()}


@pytest.fixture(scope="module")
def tiny_hrnet():
    m = jax_hrnet.HRNet(extra=jax_hrnet.TINY_EXTRA, num_joints=17)
    x = jnp.zeros((2, 64, 64, 3))
    v = random_variables(lambda k: m.init(k, x, False), seed=1)
    port = HRNet(TINY_EXTRA, 17).eval()
    port.load_state_dict(_hrnet_state_dict(v))
    return m, v, port


def test_hrnet_tiny_heatmaps_and_features(tiny_hrnet, rng):
    m, v, port = tiny_hrnet
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    hm, feats = m.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        p_hm, p_feats = port(nchw(x))
    assert tuple(p_hm.shape) == (2, 17, 16, 16)
    np.testing.assert_allclose(nhwc(p_hm), np.asarray(hm), **TOL)
    np.testing.assert_allclose(nhwc(p_feats[0]), np.asarray(feats[0]), **TOL)


def test_hrnet_w48_structure_matches_flax():
    """Every W48 flax leaf has a port parameter of the same element count."""
    m = jax_hrnet.HRNet(extra=jax_hrnet.W48_EXTRA, num_joints=17)
    shapes = jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False)
    )
    tree = {
        "params": {"final_layer": dict(shapes["params"])["final_layer"],
                   "hrnet": {k: w for k, w in shapes["params"].items()
                             if k != "final_layer"}},
        "batch_stats": {"hrnet": shapes["batch_stats"]},
    }
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    sd = {k[len("hrnet."):]: v for k, v in state_dict_from_flax(zeros).items()}
    port_sd = HRNet(jax_hrnet.W48_EXTRA, 17).state_dict()
    assert set(sd) == set(port_sd)
    for k, t in port_sd.items():
        assert tuple(t.shape) == tuple(sd[k].shape), k


def _apply_flax(module, x, seed):
    v = random_variables(lambda k: module.init(k, x), seed=seed)
    return v, np.asarray(module.apply(v, x))


def _port_from(v, port, prefix):
    """Load flax leaves of one module into a port module via the bridge:
    the module's tree is placed at ``prefix`` of a FAMIPose tree."""
    tree = {coll: {prefix: v[coll]} for coll in v}
    sd = {k[len(prefix) + 1:]: t for k, t in state_dict_from_flax(tree).items()}
    port.load_state_dict(sd)
    return port.eval()


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_chain_of_basic_blocks(rng, num_blocks):
    x = jnp.asarray(rng.randn(2, 10, 8, 6).astype(np.float32))
    flax_mod = jax_layers.ChainOfBasicBlocks(5, num_blocks=num_blocks)
    v, ref = _apply_flax(flax_mod, x, seed=num_blocks)
    port = _port_from(v, layers.ChainOfBasicBlocks(6, 5, num_blocks),
                      "sup_agg_block")
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(nhwc(got), ref, **TOL)


def test_conv_bn_act_strided(rng):
    x = jnp.asarray(rng.randn(2, 11, 9, 16).astype(np.float32))
    flax_mod = jax_layers.ConvBnAct(16, kernel_size=3, stride=2, padding=1)
    v, ref = _apply_flax(flax_mod, x, seed=3)
    tree = {coll: {"global_offset": {"down0": v[coll]}} for coll in v}
    sd = {k[len("feat_global_offset_layers.1."):]: t
          for k, t in state_dict_from_flax(tree).items()}
    port = layers.ConvBnAct(16, 16, 3, stride=2, padding=1)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    np.testing.assert_allclose(nhwc(got), ref, **TOL)


def test_interpolate_is_nearest_repeat(rng):
    x = rng.randn(1, 3, 4, 5).astype(np.float32)
    got = layers.Interpolate(4)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x.repeat(4, axis=2).repeat(4, axis=3))


def test_bf16_compute_keeps_f32_params(rng):
    """bf16 inputs run the convs in bf16 and BN in f32; parameters stay f32."""
    blk = layers.BasicBlock(4, 4).eval()
    x = torch.from_numpy(rng.randn(1, 4, 6, 6).astype(np.float32))
    with torch.no_grad():
        y = blk(x.to(torch.bfloat16))
        ref = blk(x)
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in blk.parameters())
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), atol=0.1)
