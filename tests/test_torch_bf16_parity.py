"""The configured bfloat16 path (``TPU.COMPUTE_DTYPE bfloat16`` and
``TPU.WARP_IMPL matmul``, the defaults of both packages) of the port against
the JAX package's, on the same remapped weights and inputs, at the tiny
topology (``TINY_EXTRA``, 64x64 input) of ``tests/test_torch_fami_pose.py``.

Two kinds of check.

Where each side rounds (the ``*_as_jax`` rounding tests). Each head of the
model is fed the JAX side's own bf16 inputs, captured from a JAX train-mode
forward compiled with ``xla_allow_excess_precision`` off, so that XLA rounds
to bf16 wherever the program casts (by default XLA may keep a fused value in
f32 past a cast: compiled so, JAX's feature-label MI terms differ from the
port's on the same captured inputs by 1.2-1.6%, measured here, and its
warped heatmaps in last bits):

* the global offset head (convs, train-mode BatchNorm, dense layers) gives
  JAX's offsets bit for bit;
* the warp (``impl`` matmul: weights and row pass rounded to bf16) and the
  shared final layer give JAX's supporting-frame heatmaps bit for bit;
* the six MI terms: the feature-feature terms bit for bit, the
  feature-label ones within 1e-6 relative (measured 9e-8: the f32 softmax
  sums run in another order).

So the two sides cast at the same points. The comparison found two places
where they did not, both fixed in the port: ``Conv2d`` / ``Linear`` added
their bias inside the bf16 product (flax rounds the product, then adds the
bias in bf16), and the warp blended in f32 and rounded once, as only the
JAX Pallas kernel does (the configured matmul form rounds its weights and
its row pass, the slice form every elementwise op; ``ops/warp.py`` now
follows ``TPU.WARP_IMPL``, ``tests/test_torch_warp.py`` holds each form).

The whole model end to end (the other tests), with JAX compiled as
configured. What differs is a last bit wherever the two frameworks sum a
conv's products in another order (and where XLA skips a rounding), carried
through ~50 layers in bf16: the same noise that makes each package's bf16
result differ from its f32 one. The train-mode offset head multiplies it:
its BatchNorm normalises 2 samples at 1x1 after five stride-2 convs, so the
translations of the supporting frames differ by up to 0.45 px between the
packages (and by more between bf16 and f32 in either). Each tolerance is stated
against those own gaps, measured here (the port's f32 run stands for both
packages' f32, which agree to ~6e-6 on these inputs,
``tests/test_torch_fami_pose.py``):

* heatmaps: port vs JAX 2.1-2.3% of the maps' largest value at most (limit
  4%, ten bf16 ulps there), and at most 1.5x the larger own bf16-vs-f32 gap
  in both the largest and the mean difference (measured 0.93-1.14x: two
  packages' independent roundings);
* keypoints: at least 75% of the joints decode to the same pixel (1e-3
  px) in both packages (measured 27 of 34): each package's own bf16 decode
  moves 2-5 of the 34 off its f32 position, where an argmax is decided by
  less than the noise, by whole heatmap pixels; every joint that bf16
  moves in neither package agrees;
* MSE loss terms: 2% relative (measured 0.2-0.8%) and at most 1.5x the
  larger own gap (measured <= 0.86x);
* MI terms (values ~1e-3): 5e-4 absolute (measured <= 4.2e-4). This bounds
  their size and no more: at temperature 0.05 the softmax multiplies the
  features' last-bit noise by 20, so each package's own bf16 MI terms move
  by 7-44% of their f32 values, and a fault in where the MI head casts
  would hide in that. The MI head's cast points are held by the check
  above, on shared inputs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.config import get_cfg as jax_get_cfg
from fami_pose_tpu.data.loader import prepare_train_batch as jax_prepare
from fami_pose_tpu.losses.heatmap import fami_total_loss as jax_total_loss
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.ops.heatmap import get_final_preds as jax_get_final_preds
from fami_pose_torch.config import get_cfg
from fami_pose_torch.config.node import CfgNode
from fami_pose_torch.data.loader import prepare_train_batch
from fami_pose_torch.losses import fami_total_loss
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.ops.heatmap import get_final_preds
from fami_pose_torch.ops.warp import warp_translate
from torch_port_helpers import nchw, nhwc, random_variables

MSE_TERMS = ("loss", "loss_mse", "loss_sup_mse")
MI_TERMS = ("loss_mi",) + tuple(f"loss_mi_{i}" for i in range(1, 7))
CENTER = np.array([[30, 40], [20, 25]], np.float32)
SCALE = np.array([[0.4, 0.53], [0.3, 0.4]], np.float32)
B, NUM_SUP = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(dtype):
    """The flagship YAML at the tiny topology, on both packages' configs."""
    args = types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["MODEL.IMAGE_SIZE", [64, 64], "MODEL.HEATMAP_SIZE", [16, 16],
              "TPU.COMPUTE_DTYPE", dtype, "TPU.DCN_MAX_OFFSET", 2,
              "TPU.DCN_OFFSET_GROUPS", 4])
    port, ref = get_cfg(args), jax_get_cfg(args)
    port.MODEL.EXTRA = CfgNode(TINY_EXTRA, new_allowed=True)
    ref.MODEL.EXTRA = TINY_EXTRA
    return port, ref


def _port(dtype, variables):
    pcfg, _ = _cfgs(dtype)
    port = FAMIPose.from_config(pcfg)
    port.load_state_dict(state_dict_from_flax(variables))
    assert port.warp_impl == "matmul"  # the configured warp
    return port


def _bf16(a):
    """NHWC JAX bf16 array -> NCHW torch bf16."""
    return nchw(np.asarray(a, np.float32)).bfloat16()


@pytest.fixture(scope="module")
def world():
    """Weights, eval inputs and a train batch (the seeds of the f32 parity
    tests), and every result: JAX in bf16 (as configured, and strictly
    rounded with its heads' inputs), the port in bf16 and f32, and the
    port's heads on the strict JAX inputs."""
    init = JaxFAMIPose(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
                       dcn_offset_groups=4)
    variables = random_variables(
        lambda k: init.init(k, jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64, 12)), train=False), seed=7)
    rs = np.random.RandomState(3)
    kf = rs.randn(B, 64, 64, 3).astype(np.float32)
    sup = rs.randn(B, 64, 64, 3 * NUM_SUP).astype(np.float32)
    rs = np.random.RandomState(5)
    raw = (rs.randint(0, 256, size=(B, 64, 64, 3)).astype(np.uint8),
           rs.randint(0, 256, size=(B, 64, 64, 3 * NUM_SUP)).astype(np.uint8),
           (rs.rand(B, 17, 2) * 64).astype(np.float32),
           (rs.rand(B, 17) > 0.2).astype(np.float32))
    jb = jax_prepare(*raw, B, (64, 64), (16, 16))
    pb = prepare_train_batch(*raw, B, (64, 64), (16, 16))

    _, jcfg = _cfgs("bfloat16")
    model = JaxFAMIPose.from_config(jcfg)
    assert model.dtype == jnp.bfloat16 and model.use_pallas_dcn
    assert model.warp_impl == "matmul"

    @jax.jit
    def jax_run(v):
        final, kf_bb = model.apply(v, kf, sup, train=False)
        (t_final, sup_hms, _, mi), _ = model.apply(
            v, jb["kf"], jb["sup"], train=True, mutable=["batch_stats"])
        _, aux = jax_total_loss(t_final, sup_hms, mi, jb["target"],
                                jb["target_weight"])
        return final, kf_bb, aux

    def jax_heads(v):
        """The train forward with its heads' inputs and outputs."""
        (t_final, sup_hms, _, mi), state = model.apply(
            v, jb["kf"], jb["sup"], train=True, capture_intermediates=True,
            mutable=["batch_stats", "intermediates"])
        inter = state["intermediates"]
        return dict(
            feat=inter["hrnet"]["__call__"][0][1][0],  # [key, sup1, ...]
            offsets=inter["global_offset"]["__call__"],  # one a sup frame
            sup_hms=sup_hms, final=t_final, mi=mi,
            agg_sup=inter["sup_agg_block"]["__call__"][0],
            fused=inter["init_feature_agg_block"]["__call__"][0])

    final, kf_bb, aux = jax_run(variables)
    preds, _ = jax_get_final_preds(
        jnp.transpose(final, (0, 3, 1, 2)).astype(jnp.float32), CENTER, SCALE)
    strict = jax.jit(jax_heads).lower(variables).compile(
        compiler_options={"xla_allow_excess_precision": False})(variables)
    out = {"jax": dict(final=np.asarray(final, np.float32),
                       kf_bb=np.asarray(kf_bb, np.float32),
                       preds=np.asarray(preds),
                       aux={k: float(v) for k, v in aux.items()}),
           "strict": strict}
    for dtype in ("bfloat16", "float32"):
        port = _port(dtype, variables)
        with torch.no_grad():
            p_final, p_kf_bb = port.eval()(nchw(kf), nchw(sup))
            p_preds, _ = get_final_preds(p_final.float(),
                                         torch.from_numpy(CENTER),
                                         torch.from_numpy(SCALE))
            t_final, sup_hms, _, mi = port.train()(pb["kf"], pb["sup"],
                                                   train=True)
            _, p_aux = fami_total_loss(t_final, sup_hms, mi, pb["target"],
                                       pb["target_weight"])
        assert p_final.dtype == getattr(torch, dtype)
        out[dtype] = dict(final=nhwc(p_final), kf_bb=nhwc(p_kf_bb),
                          preds=p_preds.numpy(),
                          aux={k: float(v) for k, v in p_aux.items()})
    out["heads"] = _port_heads(_port("bfloat16", variables), strict)
    return out


def _port_heads(port, strict):
    """The port's heads (train mode) on the strict JAX run's bf16 inputs."""
    feat = _bf16(strict["feat"])
    kf_feat = feat[:B]
    offsets, sup_hms = [], []
    port.train()
    with torch.no_grad():
        for i in range(NUM_SUP):
            sup_feat = feat[(i + 1) * B:(i + 2) * B]
            offsets.append(port.feat_global_offset_layers(sup_feat - kf_feat))
            off = torch.from_numpy(np.asarray(strict["offsets"][i],
                                              np.float32)).bfloat16()
            warped = warp_translate(sup_feat, off,
                                    max_shift=port.warp_max_shift,
                                    impl=port.warp_impl)
            sup_hms.append(port.hrnet.final_layer(warped))
        mi = port.mi_terms(kf_feat, _bf16(strict["agg_sup"]),
                           _bf16(strict["fused"]), _bf16(strict["final"]))
    return dict(offsets=offsets, sup_hms=sup_hms, mi=[float(v) for v in mi])


def _gaps(world, key):
    """|port - JAX| in bf16, and each package's own |bf16 - f32|."""
    f32 = world["float32"][key]
    return (np.abs(world["bfloat16"][key] - world["jax"][key]),
            np.abs(world["jax"][key] - f32),
            np.abs(world["bfloat16"][key] - f32))


def test_bf16_offset_head_rounds_as_jax(world):
    """The global offset head on JAX's bf16 feature differences: JAX's
    translations bit for bit, for each supporting frame."""
    for got, ref in zip(world["heads"]["offsets"],
                        world["strict"]["offsets"]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_bf16_warped_heatmaps_round_as_jax(world):
    """The warp (matmul roundings) and the final layer on JAX's bf16
    features and translations: JAX's supporting-frame heatmaps bit for
    bit."""
    for got, ref in zip(world["heads"]["sup_hms"],
                        world["strict"]["sup_hms"]):
        np.testing.assert_array_equal(nhwc(got), np.asarray(ref, np.float32))


def test_bf16_mi_terms_round_as_jax(world):
    """The six MI terms on JAX's bf16 features and heatmap: the
    feature-feature terms (2, 4, 6) bit for bit, the feature-label terms
    (1, 3, 5), which add the final layer and a softmax over heatmap rows,
    within 1e-6 relative."""
    got, ref = world["heads"]["mi"], [float(v) for v in world["strict"]["mi"]]
    for i in (1, 3, 5):
        assert got[i] == ref[i]
    for i in (0, 2, 4):
        assert abs(got[i] - ref[i]) <= 1e-6 * abs(ref[i])


@pytest.mark.parametrize("key", ["final", "kf_bb"])
def test_bf16_heatmaps_match_jax(world, key):
    cross, own_jax, own_port = _gaps(world, key)
    scale = float(np.abs(world["float32"][key]).max())
    assert cross.max() <= 0.04 * scale
    assert cross.max() <= 1.5 * max(own_jax.max(), own_port.max())
    assert cross.mean() <= 1.5 * max(own_jax.mean(), own_port.mean())
    # not trivially: bf16 moved both packages away from f32
    assert own_jax.max() > 1e-3 * scale and own_port.max() > 1e-3 * scale


def test_bf16_keypoints_match_jax(world):
    """(B, J, 2) pixel coordinates decoded from each side's bf16
    ``final_hm`` with its own ``get_final_preds``."""
    cross, own_jax, own_port = (g.max(axis=-1) for g in _gaps(world, "preds"))
    agree = cross <= 1e-3
    assert agree.mean() >= 0.75
    steady = (own_jax <= 1e-3) & (own_port <= 1e-3)
    assert agree[steady].all()


@pytest.mark.parametrize("term", MSE_TERMS + MI_TERMS)
def test_bf16_train_loss_terms_match_jax(world, term):
    got, ref = world["bfloat16"]["aux"][term], world["jax"]["aux"][term]
    f32 = world["float32"]["aux"][term]
    cross = abs(got - ref)
    if term in MSE_TERMS:
        assert cross <= 0.02 * abs(f32)
        assert cross <= 1.5 * max(abs(ref - f32), abs(got - f32))
    else:  # a bound on size only (see the module's docstring)
        assert cross <= 5e-4
