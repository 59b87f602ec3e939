"""Train-mode layers and the train-mode FAMIPose of the port against the JAX
package, on the same flax variables (bridged with ``state_dict_from_flax``)
and the same numpy inputs, at the tiny topology.

Tolerances (f32 on both sides, sums in other orders): BatchNorm outputs and
statistics 1e-5; the model's backbone heatmaps 2e-4 absolute + relative; the
head's outputs 5e-4 relative + 5e-4 of their largest magnitude: at this size
the offset head's last two BatchNorms normalize over B = 2 values per
channel, which amplifies f32 rounding into the predicted translations (2e-5
to 3e-4 of the largest magnitude over the seeds and batch sizes tried); the
MI terms 5e-4 relative + 1e-7: they are means of softmax differences at
temperature 0.05, of magnitude 1e-4..1e-2.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.models.layers import BatchNorm as JaxBatchNorm
from fami_pose_tpu.models.layers import ConvBnAct as JaxConvBnAct
from fami_pose_torch.models.bridge import init_weights, state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose, init_weights_reference
from fami_pose_torch.models.layers import BatchNorm, ConvBnAct
from torch_port_helpers import nchw, nhwc, random_variables

TOL = dict(rtol=2e-4, atol=2e-4)
JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=5e-4,
                               atol=5e-4 * max(1.0, float(np.abs(ref).max())))


def test_train_batchnorm_matches_flax(rng):
    """Batch statistics in the output; running statistics moved by 0.1, the
    variance by the BIASED batch variance, over two successive calls."""
    x1 = (rng.randn(4, 5, 6, 3) * 2 + 1).astype(np.float32)
    x2 = (rng.randn(4, 5, 6, 3) * 0.5 - 2).astype(np.float32)
    m = JaxBatchNorm()
    variables = {
        "params": {"bn": {"scale": rng.rand(3).astype(np.float32) + 0.5,
                          "bias": rng.randn(3).astype(np.float32)}},
        "batch_stats": {"bn": {"mean": rng.randn(3).astype(np.float32),
                               "var": rng.rand(3).astype(np.float32) + 0.5}},
    }
    port = BatchNorm(3).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["bn"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bn"]["bias"]))
        port.running_mean.copy_(
            torch.from_numpy(variables["batch_stats"]["bn"]["mean"]))
        port.running_var.copy_(
            torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    for x in (x1, x2):
        y, mut = m.apply(variables, jnp.asarray(x), True,
                         mutable=["batch_stats"])
        variables = {"params": variables["params"], **mut}
        got = port(nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
        stats = variables["batch_stats"]["bn"]
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)
    # the unbiased variance would differ by n/(n-1) in the update
    biased = 0.1 * x2.var(axis=(0, 1, 2))
    assert np.all(np.abs(biased * (120 / 119 - 1)) > 1e-6)


def test_train_batchnorm_eval_mode_leaves_statistics(rng):
    port = BatchNorm(3).eval()
    before = port.running_var.clone()
    port(nchw(rng.randn(2, 4, 4, 3).astype(np.float32)))
    assert torch.equal(port.running_var, before)


def test_train_batchnorm_bf16_input(rng):
    """bfloat16 in, float32 statistics, bfloat16 out; gradients reach the
    input and the float32 parameters."""
    port = BatchNorm(3).train()
    x = nchw(rng.randn(2, 4, 4, 3).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_()
    y = port(x)
    assert y.dtype == torch.bfloat16 and port.running_mean.dtype == torch.float32
    y.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and port.weight.grad.dtype == torch.float32


def test_train_conv_bn_act_gradients_match_flax(rng):
    """conv + train-mode BatchNorm + ReLU: output, parameter gradients and
    input gradient against ``jax.grad``."""
    x = rng.randn(3, 7, 6, 4).astype(np.float32)
    gout = rng.randn(3, 7, 6, 5).astype(np.float32)
    m = JaxConvBnAct(5)
    variables = random_variables(
        lambda k: m.init(k, jnp.asarray(x), False), seed=1)

    def loss(params, xin):
        y, _ = m.apply({"params": params,
                        "batch_stats": variables["batch_stats"]}, xin, True,
                       mutable=["batch_stats"])
        return jnp.sum(y * gout)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                                    jnp.asarray(x))
    port = ConvBnAct(4, 5).train()
    with torch.no_grad():
        p = variables["params"]
        port.conv.weight.copy_(torch.from_numpy(
            np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        port.conv.bias.copy_(torch.from_numpy(np.asarray(p["conv"]["bias"])))
        port.bn.weight.copy_(torch.from_numpy(
            np.asarray(p["norm"]["bn"]["scale"])))
        port.bn.bias.copy_(torch.from_numpy(np.asarray(p["norm"]["bn"]["bias"])))
    xin = nchw(x).requires_grad_()
    (port(xin) * nchw(gout)).sum().backward()
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(nhwc(xin.grad), np.asarray(g_x), **tol)
    np.testing.assert_allclose(
        port.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
        np.asarray(g_params["conv"]["kernel"]), **tol)
    np.testing.assert_allclose(port.bn.weight.grad.numpy(),
                               np.asarray(g_params["norm"]["bn"]["scale"]),
                               **tol)
    np.testing.assert_allclose(port.bn.bias.grad.numpy(),
                               np.asarray(g_params["norm"]["bn"]["bias"]),
                               **tol)


@pytest.fixture(scope="module")
def variables():
    m = JaxFAMIPose(**JAX_KW)
    kf = jnp.zeros((1, 64, 64, 3))
    sup = jnp.zeros((1, 64, 64, 12))
    return random_variables(lambda k: m.init(k, kf, sup, train=False), seed=7)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(5)
    return (rs.randn(2, 64, 64, 3).astype(np.float32),
            rs.randn(2, 64, 64, 12).astype(np.float32))


def _port_model(max_offset, state_dict):
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
                 feat_hw=(16, 16), dcn_offset_groups=4,
                 dcn_max_offset=max_offset, warp_max_shift=26)
    m.load_state_dict(state_dict)
    return m.train()


@pytest.mark.parametrize(
    "use_pallas,max_offset", [(False, 2), (True, 2), (False, None)],
    ids=["windowed-D2", "pallas-D2", "exact"],
)
def test_train_forward_matches_jax(variables, inputs, use_pallas, max_offset):
    """All four outputs, the six MI terms and the BatchNorm statistics after
    one train-mode forward (four sequential updates in the offset head)."""
    kf, sup = inputs
    m = JaxFAMIPose(dcn_max_offset=max_offset, use_pallas_dcn=use_pallas,
                    **JAX_KW)
    (final, sup_hms, kf_bb, mi), mut = jax.jit(
        lambda v, a, b: m.apply(v, a, b, train=True, mutable=["batch_stats"])
    )(variables, kf, sup)
    port = _port_model(max_offset, state_dict_from_flax(variables))
    p_final, p_sup_hms, p_kf_bb, p_mi = port(nchw(kf), nchw(sup), train=True)
    assert tuple(p_final.shape) == (2, 17, 16, 16) and len(p_sup_hms) == 4
    np.testing.assert_allclose(nhwc(p_kf_bb), np.asarray(kf_bb), **TOL)
    _close(nhwc(p_final), final)
    for got, ref in zip(p_sup_hms, sup_hms):
        _close(nhwc(got), ref)
    assert len(p_mi) == 6 and all(t.dtype == torch.float32 for t in p_mi)
    np.testing.assert_allclose([float(t) for t in p_mi],
                               [float(t) for t in mi], rtol=5e-4, atol=1e-7)
    assert float(p_mi[1]) == float(p_mi[5])  # terms 2 and 6: one expression

    want = state_dict_from_flax({"params": variables["params"], **mut})
    got = port.state_dict()
    moved = 0
    for key, ref in want.items():
        if "running_" not in key:
            continue
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=key)
        moved += 1
    assert moved > 50


def test_train_flag_must_agree_with_module_mode(variables, inputs):
    kf, sup = inputs
    port = _port_model(2, state_dict_from_flax(variables))
    with pytest.raises(ValueError, match="train"):
        port(nchw(kf), nchw(sup), train=False)
    port.eval()
    with pytest.raises(ValueError, match="eval"):
        port(nchw(kf), nchw(sup), train=True)
    with torch.no_grad():
        assert len(port(nchw(kf), nchw(sup))) == 2


def test_mi_rows_follow_the_jax_flattening():
    """The feature-label MI term cuts its (B*J, h*w) rows out of the NHWC
    flattening, as the JAX package does, not out of per-joint maps."""
    rs = np.random.RandomState(0)
    port = init_weights(FAMIPose(
        extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
        feat_hw=(16, 16), dcn_offset_groups=4), seed=1)
    feat = torch.from_numpy(rs.randn(2, 8, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randn(2, 17, 16, 16).astype(np.float32))
    got = float(port._feat_label_mi(feat, y))
    pred = port.hrnet.final_layer(feat).detach()
    rows = lambda t: jnp.asarray(nhwc(t)).reshape(2 * 17, -1) / 0.05
    p = jax.nn.softmax(rows(pred), axis=1)
    q = jax.nn.softmax(rows(y), axis=1)
    want = float(jnp.mean(q * jax.nn.log_softmax(rows(y), axis=1) - q * p))
    assert abs(got - want) <= 2e-4 * abs(want) + 1e-7


def test_init_weights_reference_touches_the_head_only():
    port = init_weights(FAMIPose(
        extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
        feat_hw=(16, 16), dcn_offset_groups=4), seed=1)
    with torch.no_grad():
        port.dcn_2.bias.fill_(0.3)
        port.sup_agg_block.layers[0].bn1.weight.fill_(0.7)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    init_weights_reference(port, seed=2)
    after = port.state_dict()
    for key in before:
        same = torch.equal(before[key], after[key])
        backbone = key.startswith("hrnet.") and "final_layer" not in key
        if backbone or "running_" in key or key in (
                "dcn_1.weight", "dcn_2.weight", "dcn_3.weight", "dcn_4.weight"):
            assert same, key
    assert float(after["dcn_2.bias"].abs().max()) == 0.0
    assert float(after["sup_agg_block.layers.0.bn1.weight"].min()) == 1.0
    w = after["hrnet.final_layer.weight"]  # scoped outside the backbone in JAX
    assert not torch.equal(w, before["hrnet.final_layer.weight"])
    head = torch.cat([after[k].flatten() for k in after
                      if k.endswith("conv.weight") and k.startswith("dcn_")])
    assert 0.0008 < float(head.std()) < 0.0012
    again = init_weights_reference(port, seed=2).state_dict()
    assert all(torch.equal(after[k], again[k]) for k in after)
