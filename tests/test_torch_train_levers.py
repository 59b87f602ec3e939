"""The train-time levers of the port's trainer against the JAX package's, at
the tiny topology on the CPU: the train-time device crop
(``TPU.DEVICE_CROP``) and ``reverse_transforms``; ``TPU.REMAT_BACKBONE``;
``TPU.BF16_GRADS``; the profiler (``TPU.PROFILE_DIR``), the metric writer
and async checkpoints (``TPU.ASYNC_CHECKPOINT``); the core-function and
model registries; the refusals that are left; and all of them at once in
``Trainer.train``.

Tolerances, by check:

* Device crop: the port's against JAX's ``prepare_train_batch_device_crop``
  on one raw batch, inputs within 5e-3 of the 0..255 scale (two float32
  bilinear samplers, as ``tests/test_torch_evaluator.py`` holds the eval
  crop), targets 1e-6, weights exactly; against the host crop (``cv2``
  rounds to uint8) as ``tests/test_device_crop.py`` holds JAX's: 0.06 on
  the normalized inputs, 1e-6 on the targets.
* ``reverse_transforms``: bit for bit.
* Remat: one float32 step with ``REMAT_BACKBONE`` equals the step without
  it bit for bit on the CPU (gradients, running statistics, parameters),
  each stage module runs twice and the statistics move once; against JAX's
  rematerialized model (``nn.remat``, its XLA DCN), the gradient and
  statistics bounds of ``tests/test_torch_train_step.py``.
* ``BF16_GRADS``, the mechanism, exactly: ``params_cast`` to float32 puts
  the plain backward's gradients on the parameters bit for bit, and the
  lever's gradients are those of the same model with bfloat16 parameters,
  bit for bit, with and without remat.
* ``BF16_GRADS`` against JAX: one Adam step against JAX's
  ``make_train_step(..., bf16_grads=True)`` on the flagship YAML at the
  tiny topology (bf16, the Pallas DCN) at 128x128 (``BF16_SIZE`` says why
  not 64x64), compiled with ``xla_allow_excess_precision`` off. A bf16 step
  of the seeded weights is chaotic in both packages: a train step
  normalizes with the batch's statistics (so calibrating the running ones
  changes nothing), and BatchNorm followed by ReLU grows a rounding from
  layer to layer (the bf16 forward's gap to f32 goes from 0.4% after the
  stem to 11% at the backbone's output): the median tensor of JAX's bf16
  gradients lies 78 times its f32 size from the f32 gradient, the port's
  1.3 times (with the head at the reference init, 1.4 and 1.5), so a
  bound scaled by either gap passes any fault. The step therefore runs on
  tame weights (:func:`tame_variables`): each BatchNorm's scale 0.1 and
  shift 1, so every ReLU after one passes, and the head's kernels at half
  size; there JAX's own gap is at most 0.2 of the f32 gradient in 166 of
  255 tensors, every DCN weight, offset and mask conv, the offset head's
  last layer and the stem among them (measured here). Those tensors are
  held, per tensor in L2, to ``|port - JAX| <= 3 |JAX - f32| + 2^-6 |f32|``
  (``bf16_judge.bf16_rule``, by which phase ``train-levers`` also holds the
  card's step against the CPU's: JAX's own gap alone, plus a fixed bf16
  scale; norms in float64, as float32 squares entries under ~1e-19 to
  zero; measured at most 0.64 of
  the bound, median 0.25), and a fault planted in one of five of them
  (doubled, zeroed, sign flipped) breaks the rule there and nowhere else
  (measured at least 2.2 times the bound). The same bound holds every loss
  term (at most 0.14 of it) and every running statistic in max-abs, with
  the f32 step's move for scale (at most 0.16). Every gradient of both
  packages is a bf16 value, and the f32 step's are not. New parameters:
  the port's follow Adam's first step on its own gradient to 1e-6 (where
  g^2 is a normal float32), and in each held tensor at least half of JAX's
  moves are the port's to 1e-2 lr (measured at least 75%, median 99%).
  Over 2 gloo processes, one sample each, the averaged gradient (each
  rank's bf16 gradient summed across ranks in float32) is held by the same
  rule, and the ranks to each other bit for bit.
* ``BF16_GRADS`` judged by ensembles of roundings
  (``fami_pose_torch/tools/bf16_judge.py``; its tolerances ``BF16_TAME``,
  ``BF16_CROSS``, ``BF16_SCALE`` as above, the spread of the members in
  place of one gap): the port's ensemble (the nominal step, the nudged
  steps of ``NUDGE_SEEDS``) holds 186 of 255 tensors (``bf16_rule`` holds
  166) and its held-out control steps (``CONTROL_SEEDS``) break none
  (measured at most 0.69 of the bound), nor does the step whose DCN
  rounds the sampled column to bf16 as the card's kernels do (at most
  0.17; ``torch_bf16_ensemble.card_rounding``); JAX's ensemble (its one compiled step on the batch and on nudged
  copies: no new compile) holds the port in gradients (150 held, at most
  0.36), loss terms and statistics; the port's ensemble holds JAX's loss
  terms and statistics, and of JAX's gradients breaks 20 of the 186 held,
  on each of which JAX's own gap to the f32 step is 3.5 to 316 times the
  largest port rounding's (asserted: at least ``BF16_CROSS``; XLA's CPU
  backend sums bf16 bias gradients in bf16,
  ``tests/test_torch_bf16_ensemble.py``); a fault planted in a control
  step (x2, x0, x-1, and x1.25 but at the stem conv, whose sharpness is
  x1.5: ``BF16_COARSE``) breaks the rule at its tensor alone; and a
  gradient taken from the f32 step is named (``not_bf16``).
"""

import json
import os
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import SyntheticPoseDataset
from fami_pose_tpu.config import get_cfg as jax_get_cfg
from fami_pose_tpu.data import loader as jax_loader
from fami_pose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrack
from fami_pose_tpu.engine import core_functions as jax_core
from fami_pose_tpu.engine.metrics_writer import MetricWriter as JaxMetricWriter
from fami_pose_tpu.engine.steps import make_train_step as jax_make_train_step
from fami_pose_tpu.engine.train_state import TrainState as JaxTrainState
from fami_pose_tpu.losses.heatmap import fami_total_loss as jax_total_loss
from fami_pose_tpu.models import build_model as jax_build_model
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.optim.optimizer import build_optimizer as jax_build_optimizer
from fami_pose_tpu.utils.registry import (
    CORE_FUNCTION_REGISTRY as JAX_CORE_REGISTRY,
    MODEL_REGISTRY as JAX_MODEL_REGISTRY,
)
from fami_pose_torch.config import get_cfg
from fami_pose_torch.config.node import CfgNode
from fami_pose_torch.data.loader import (
    collate, prepare_train_batch, prepare_train_batch_device_crop,
    reverse_transforms,
)
from fami_pose_torch.data.posetrack import PoseTrackDataset
from fami_pose_torch.data.video_dataset import IMAGENET_STD
from fami_pose_torch.engine import checkpoints
from fami_pose_torch.engine.core_functions import (
    AlignmentMIFunction, build_core_function,
)
from fami_pose_torch.engine.evaluator import check_supported as ev_check
from fami_pose_torch.engine.metrics_writer import MetricWriter
from fami_pose_torch.engine.steps import make_train_step, params_cast
from fami_pose_torch.engine.train_state import TrainState
from fami_pose_torch.losses import fami_total_loss
from fami_pose_torch.engine.trainer import Trainer, check_supported
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.build import build_model
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.optim import build_optimizer
from fami_pose_torch.tools import bf16_judge as J
from fami_pose_torch.tools.bf16_judge import (
    BF16_CROSS, BF16_HELD, BF16_SCALE, bf16_rule,
)
from fami_pose_torch.utils.profiling import StepTimer, trace
from fami_pose_torch.utils.registry import CORE_FUNCTION_REGISTRY, MODEL_REGISTRY
from fixtures import make_cfg, make_posetrack_fixture
from test_torch_pretrained import backbone_pth
from torch_bf16_ensemble import (
    card_rounded_step, jax_ensemble, jax_outputs, port_outputs,
    running_stats, strays, with_f32, with_fault,
)
from torch_dist import run_ranks
from torch_port_helpers import make_port_cfg, random_variables

JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4, dcn_max_offset=2)
MSE_TERMS = ("loss", "loss_mse", "loss_sup_mse")
MI_TERMS = ("loss_mi",) + tuple(f"loss_mi_{i}" for i in range(1, 7))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- the device crop and reverse_transforms -------------------------------------

@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("levers_crop")
    _, img_dir = make_posetrack_fixture(str(root))
    return str(root / "json"), img_dir


def _crop_cfg(fixture_dirs, make, device_crop):
    cfg = make(*fixture_dirs)
    cfg.TRAIN.SCALE_FACTOR = 0.0
    cfg.TRAIN.ROT_FACTOR = 0
    cfg.TRAIN.FLIP = False
    cfg.TPU.DEVICE_CROP = device_crop
    cfg.TPU.DEVICE_CROP_CANVAS = [192, 192]
    return cfg


def test_train_device_crop_matches_jax_and_the_host_crop(fixture_dirs):
    cfg = _crop_cfg(fixture_dirs, make_port_cfg, False)
    host = collate([PoseTrackDataset(cfg, "validate")[i] for i in range(4)])
    raw = collate([PoseTrackDataset(
        _crop_cfg(fixture_dirs, make_port_cfg, True), "validate")[i]
        for i in range(4)])
    jraw = collate([JaxPoseTrack(
        _crop_cfg(fixture_dirs, make_cfg, True), "validate")[i]
        for i in range(4)])
    for k in ("kf", "sup", "crop_center", "scale", "rotation", "joints"):
        np.testing.assert_array_equal(raw[k], jraw[k])
    kw = dict(sigma=2, image_size=(96, 128), heatmap_size=(24, 32))
    args = [raw[k] for k in ("kf", "sup", "crop_center", "scale", "rotation",
                             "joints", "joints_vis")]
    got = prepare_train_batch_device_crop(*args, **kw)
    ref = jax_loader.prepare_train_batch_device_crop(*args, **kw)
    want = prepare_train_batch(host["kf"], host["sup"], host["joints"],
                               host["joints_vis"], **kw)
    assert tuple(got["kf"].shape) == (4, 3, 128, 96)
    assert tuple(got["sup"].shape) == (4, 12, 128, 96)
    for k in ("kf", "sup"):  # the host batch's memory order
        assert got[k].stride() == want[k].stride(), k
    atol = 5e-3 / (255.0 * float(IMAGENET_STD.min()))
    for k in ("kf", "sup"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[k]), atol=atol, rtol=0)
        assert float((got[k] - want[k]).abs().max()) < 0.06, k
    np.testing.assert_allclose(got["target"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref["target"]), atol=1e-6)
    np.testing.assert_allclose(got["target"].numpy(), want["target"].numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  want["target_weight"].numpy())


def test_reverse_transforms_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 6, 8, 5) * 1.5).astype(np.float32)  # (N, 3k, H, W)
    got = reverse_transforms(torch.from_numpy(x))
    ref = jax_loader.reverse_transforms(x.transpose(0, 2, 3, 1))
    assert got.dtype == np.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), ref)
    # normalized uint8 pixels come back as they were
    from fami_pose_torch.data.loader import normalize

    u8 = rs.randint(0, 256, size=(2, 3, 4, 4)).astype(np.uint8)
    back = reverse_transforms(normalize(torch.from_numpy(u8)))
    assert np.abs(back.astype(int) - u8.astype(int)).max() <= 1


# -- REMAT_BACKBONE -----------------------------------------------------------------

@pytest.fixture(scope="module")
def variables():
    m = JaxFAMIPose(**JAX_KW)
    return random_variables(
        lambda k: m.init(k, jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 12)), train=False), seed=7)


@pytest.fixture(scope="module")
def raw_batch():
    rs = np.random.RandomState(5)
    return (rs.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8),
            rs.randint(0, 256, size=(2, 64, 64, 12)).astype(np.uint8),
            (rs.rand(2, 17, 2) * 64).astype(np.float32),
            (rs.rand(2, 17) > 0.2).astype(np.float32))


def _adam_cfg():
    cfg = get_cfg()
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.LR_STEP = [2, 3]
    return cfg


def _remat_step(variables, batch, remat):
    """One f32 Adam step of the port, with or without remat; returns the
    gradients, the state after the step and the number of forward calls of
    every stage module."""
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
                 feat_hw=(16, 16), dcn_offset_groups=4, dcn_max_offset=2,
                 warp_max_shift=26, remat_backbone=remat)
    m.load_state_dict(state_dict_from_flax(variables))
    m.train()
    calls = []
    for name in ("stage2", "stage3", "stage4"):
        for module in getattr(m.hrnet, name):
            module.register_forward_pre_hook(lambda *_: calls.append(1))
    opt, sched = build_optimizer(_adam_cfg(), m, steps_per_epoch=5)
    state, metrics = make_train_step()(TrainState(m, opt, sched), batch)
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    return grads, m.state_dict(), metrics, len(calls)


@pytest.fixture(scope="module")
def jax_remat(variables, raw_batch):
    """Loss terms, gradients and new statistics of JAX's rematerialized
    model (``nn.remat`` over each HighResolutionModule; the XLA DCN)."""
    jb = jax_loader.prepare_train_batch(*raw_batch, 2, (64, 64), (16, 16))
    model = JaxFAMIPose(use_pallas_dcn=False, remat_backbone=True, **JAX_KW)
    stats = variables["batch_stats"]

    def loss_fn(p):
        (final, sup_hms, _, mi), mut = model.apply(
            {"params": p, "batch_stats": stats}, jb["kf"], jb["sup"],
            train=True, mutable=["batch_stats"])
        total, aux = jax_total_loss(final, sup_hms, mi, jb["target"],
                                    jb["target_weight"])
        return total, (aux, mut["batch_stats"])

    (_, (aux, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    out = state_dict_from_flax({
        "params": jax.tree.map(np.asarray, grads),
        "batch_stats": jax.tree.map(np.asarray, new_stats)})
    return {k: float(v) for k, v in aux.items()}, out


def test_remat_step_equals_the_step_without_remat(variables, raw_batch):
    batch = prepare_train_batch(*raw_batch, 2, (64, 64), (16, 16))
    g0, s0, m0, calls0 = _remat_step(variables, batch, remat=False)
    g1, s1, m1, calls1 = _remat_step(variables, batch, remat=True)
    assert calls1 == 2 * calls0 == 6  # each module again in the backward
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:  # parameters after Adam, and statistics moved once
        assert torch.equal(s0[k], s1[k]), k
    moved = [k for k in s0 if "running_" in k
             and not torch.equal(s0[k], state_dict_from_flax(variables)[k])]
    assert len(moved) > 100
    # an eval forward or one without gradients does not rematerialize
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
                 feat_hw=(16, 16), dcn_offset_groups=4, dcn_max_offset=2,
                 remat_backbone=True)
    assert m.hrnet.remat
    with torch.no_grad():
        m.train()(batch["kf"], batch["sup"], train=True)


def test_remat_step_matches_jax_remat(variables, raw_batch, jax_remat):
    ref_aux, ref = jax_remat
    batch = prepare_train_batch(*raw_batch, 2, (64, 64), (16, 16))
    grads, state, metrics, _ = _remat_step(variables, batch, remat=True)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=5e-4,
                                   atol=1e-6, err_msg=k)
    scale = max(float(ref[n].abs().max()) for n in grads)
    floor = 2e-5 * scale
    rel_l2 = {}
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=2e-3,
                                   atol=5e-3 * scale, err_msg=n)
        if float(ref[n].abs().max()) > floor:
            rel_l2[n] = float((g - ref[n]).norm() / ref[n].norm())
    assert len(rel_l2) >= 0.95 * len(grads)
    assert max(rel_l2.values()) <= 0.1
    assert float(np.median(list(rel_l2.values()))) <= 5e-3
    for k in state:
        if "running_" in k:
            np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=k)


# -- BF16_GRADS -----------------------------------------------------------------------

# the bf16 step's input size: at 64x64 the offset head's last conv takes a
# 1x1 map, and the CPU library's bf16 weight gradient of a 3x3 stride-2
# conv on a 1x1 map comes back as garbage (NaN, or up to 1e38) from run to
# run; at 128x128 it takes 2x2
BF16_SIZE = 128
# the judge's sharpness where it is coarser than bf16_judge.FINE_FAULT
# (measured here)
BF16_COARSE = {"hrnet.conv1.weight": 1.5}


def tame_variables(variables):
    """``variables`` with every BatchNorm's scale set to 0.1 and its shift
    to 1 (each +-10%, seeded), so that each ReLU after a BatchNorm passes
    its input, and every kernel outside the backbone but the four DCNs'
    own at half its size (module docstring)."""
    rs = np.random.RandomState(3)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            elif path[-1:] == ("bn",) and k in ("scale", "bias"):
                centre = 0.1 if k == "scale" else 1.0
                out[k] = (centre * (1 + 0.1 * rs.randn(*v.shape))
                          ).astype(np.float32)
            elif (k == "kernel" and path[0] != "hrnet"
                  and not (len(path) == 1 and path[0].startswith("dcn_"))):
                out[k] = (np.asarray(v) * 0.5).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"params": walk(variables["params"], ()),
            "batch_stats": variables["batch_stats"]}


def _yaml_cfgs(dtype):
    """The flagship YAML at the tiny topology, on both packages' configs."""
    hm = BF16_SIZE // 4
    args = types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["MODEL.IMAGE_SIZE", [BF16_SIZE, BF16_SIZE],
              "MODEL.HEATMAP_SIZE", [hm, hm],
              "TPU.COMPUTE_DTYPE", dtype, "TPU.DCN_MAX_OFFSET", 2,
              "TPU.DCN_OFFSET_GROUPS", 4, "TRAIN.LR_STEP", [2, 3]])
    port, ref = get_cfg(args), jax_get_cfg(args)
    port.MODEL.EXTRA = CfgNode(TINY_EXTRA, new_allowed=True)
    ref.MODEL.EXTRA = TINY_EXTRA
    return port, ref


@pytest.fixture(scope="module")
def bf16_inputs():
    """Tame seeded weights at ``BF16_SIZE`` and a raw batch of 2."""
    size = BF16_SIZE
    init = JaxFAMIPose(**JAX_KW)
    variables = tame_variables(random_variables(
        lambda k: init.init(k, jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, size, size, 12)), train=False),
        seed=7))
    rs = np.random.RandomState(5)
    raw_batch = (
        rs.randint(0, 256, size=(2, size, size, 3)).astype(np.uint8),
        rs.randint(0, 256, size=(2, size, size, 12)).astype(np.uint8),
        (rs.rand(2, 17, 2) * size).astype(np.float32),
        (rs.rand(2, 17) > 0.2).astype(np.float32))
    return variables, raw_batch


def _bf16_batch(raw_batch):
    hm = BF16_SIZE // 4
    return prepare_train_batch(*raw_batch, 2, (BF16_SIZE, BF16_SIZE),
                               (hm, hm))


def _port_model(variables, dtype, remat=False):
    cfg, _ = _yaml_cfgs(dtype)
    cfg.TPU.REMAT_BACKBONE = remat
    m = FAMIPose.from_config(cfg)
    m.load_state_dict(state_dict_from_flax(variables))
    return cfg, m.train()


def _port_bf16_step(variables, batch, dtype, bf16_grads, remat=False):
    cfg, m = _port_model(variables, dtype, remat)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt, sched = build_optimizer(cfg, m, steps_per_epoch=5)
    _, metrics = make_train_step(bf16_grads=bf16_grads)(
        TrainState(m, opt, sched), batch)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    return dict(grads={n: p.grad.clone() for n, p in m.named_parameters()},
                state=m.state_dict(), before=before,
                aux={k: float(v) for k, v in metrics.items()},
                lr=float(cfg.TRAIN.LR))


def _loss(model, batch):
    final, sup_hms, _, mi = model(batch["kf"], batch["sup"], train=True)
    return fami_total_loss(final, sup_hms, mi, batch["target"],
                           batch["target_weight"], mi_alpha=0.5,
                           mi_beta=0.1)[0]


def test_params_cast_to_float32_gives_the_plain_gradients(bf16_inputs):
    """``params_cast`` to the parameters' own dtype: the gradients it puts
    on the parameters are the plain backward's, bit for bit, and the
    parameters are the same objects, values and dtype afterwards."""
    variables, raw_batch = bf16_inputs
    batch = _bf16_batch(raw_batch)
    _, plain = _port_model(variables, "float32")
    _loss(plain, batch).backward()
    _, m = _port_model(variables, "float32")
    params = dict(m.named_parameters())
    values = {n: p.detach().clone() for n, p in params.items()}
    with params_cast(m, torch.float32) as copies:
        assert all(getattr(m.get_submodule(n.rpartition(".")[0]),
                           n.rpartition(".")[2]) is copies[id(p)]
                   for n, p in params.items())
        _loss(m, batch).backward()
    assert dict(m.named_parameters()) == params
    for n, p in m.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, values[n]), n
        assert torch.equal(p.grad, dict(plain.named_parameters())[n].grad), n


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bf16_grads_are_the_gradients_of_a_bf16_model(bf16_inputs, remat):
    """The lever's gradients are those of the same model whose floating
    parameters are bfloat16 tensors (a second way to differentiate with
    respect to a bf16 cast), cast to float32: bit for bit, with and without
    remat (its second pass runs inside the backward)."""
    variables, raw_batch = bf16_inputs
    batch = _bf16_batch(raw_batch)
    lever = _port_bf16_step(variables, batch, "bfloat16", True, remat)
    _, m = _port_model(variables, "bfloat16", remat)
    for p in m.parameters():
        p.data = p.data.to(torch.bfloat16)
    _loss(m, batch).backward()
    for n, p in m.named_parameters():
        assert p.grad.dtype == torch.bfloat16, n
        assert torch.equal(lever["grads"][n], p.grad.float()), n


@pytest.fixture(scope="module")
def bf16_world(bf16_inputs):
    """JAX's bf16_grads Adam step (its gradients kept by a transformation
    that records them beside Adam's state), and the port's bf16_grads and
    f32 steps from the same tame weights and batch."""
    variables, raw_batch = bf16_inputs
    size, hm = BF16_SIZE, BF16_SIZE // 4
    _, jcfg = _yaml_cfgs("bfloat16")
    model = JaxFAMIPose.from_config(jcfg)
    assert model.dtype == jnp.bfloat16 and model.use_pallas_dcn
    adam = jax_build_optimizer(jcfg, steps_per_epoch=5)

    def update(g, s, p=None):
        updates, adam_state = adam.update(g, s[0], p)
        return updates, (adam_state, g)

    tx = optax.GradientTransformation(
        lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    params = variables["params"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), tx=tx)
    jb = jax_loader.prepare_train_batch(*raw_batch, 2, (size, size), (hm, hm))
    step = jax_make_train_step(model, donate=False, bf16_grads=True)
    compiled = step.lower(state, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    new, metrics = compiled(state, jb)
    jax_side = dict(
        grads=state_dict_from_flax({"params": jax.tree.map(
            lambda a: np.asarray(a, np.float32), new.opt_state[1])}),
        state=state_dict_from_flax({
            "params": jax.tree.map(np.asarray, new.params),
            "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}),
        aux={k: float(v) for k, v in metrics.items()})
    batch = _bf16_batch(raw_batch)
    return dict(jax=jax_side,
                port=_port_bf16_step(variables, batch, "bfloat16", True),
                f32=_port_bf16_step(variables, batch, "float32", False),
                jax_step=lambda b: jax_outputs(*compiled(state, b)),
                jax_batch=jb)


def test_bf16_grads_are_bf16_values(bf16_world):
    """Both packages' gradients are bf16 numbers cast back to float32; the
    float32 step's are not."""
    def all_bf16(g):
        return all(torch.equal(t, t.bfloat16().float()) for t in g.values())

    assert all_bf16(bf16_world["port"]["grads"])
    assert all_bf16(bf16_world["jax"]["grads"])
    assert not all_bf16(bf16_world["f32"]["grads"])


@pytest.mark.parametrize("term", MSE_TERMS + MI_TERMS)
def test_bf16_grads_loss_terms_match_jax(bf16_world, term):
    got = bf16_world["port"]["aux"][term]
    ref = bf16_world["jax"]["aux"][term]
    f32 = bf16_world["f32"]["aux"][term]
    assert abs(got - ref) <= BF16_CROSS * abs(ref - f32) \
        + BF16_SCALE * abs(f32)


def test_bf16_grads_gradients_match_jax(bf16_world):
    got, ref = bf16_world["port"]["grads"], bf16_world["jax"]["grads"]
    f32 = bf16_world["f32"]["grads"]
    assert set(got) == set(ref) == set(f32)
    held, broken, ratios = bf16_rule(got, ref, f32)
    assert not broken, {n: ratios[n] for n in broken}
    assert len(held) >= 0.6 * len(f32), len(held)
    dcn = [n for n in f32 if n.startswith("dcn") and n.endswith("weight")]
    assert len(dcn) == 12 and set(dcn + list(BF16_HELD)) <= set(held)


@pytest.mark.parametrize("fault", [2.0, 0.0, -1.0],
                         ids=["doubled", "zeroed", "sign"])
@pytest.mark.parametrize("name", BF16_HELD)
def test_bf16_rule_catches_a_planted_fault(bf16_world, name, fault):
    """One gradient tensor of the port doubled, zeroed or of the wrong
    sign breaks the rule there, and nowhere else."""
    got = dict(bf16_world["port"]["grads"])
    got[name] = fault * got[name]
    _, broken, _ = bf16_rule(got, bf16_world["jax"]["grads"],
                             bf16_world["f32"]["grads"])
    assert broken == [name]


def test_bf16_grads_parameters_and_statistics_match_jax(bf16_world):
    port, jx, f32 = bf16_world["port"], bf16_world["jax"], bf16_world["f32"]
    lr = port["lr"]
    held, _, _ = bf16_rule(port["grads"], jx["grads"], f32["grads"])
    for key, ref in jx["state"].items():
        got = port["state"][key]
        before = port["before"][key]
        if "running_" in key:
            own = float((ref - f32["state"][key]).abs().max())
            moved = float((f32["state"][key] - before).abs().max())
            cross = float((got - ref).abs().max())
            assert cross <= BF16_CROSS * own + BF16_SCALE * moved, key
            continue
        g = port["grads"][key]
        # Adam's first step, lr * g / (|g| + eps), where g^2 is a normal
        # float32 number; below that v underflows and the step is < lr
        closed_form = before - lr * g / (g.abs() + 1e-8)
        normal = g.abs() > 1e-15
        assert bool(((got - closed_form).abs()[normal] <= 1e-6).all()), key
        if key in held:  # at least half of JAX's moves, to 1e-2 lr
            moved = (ref - before).abs() > 0
            close = (got - ref).abs()[moved] <= 1e-2 * lr
            assert float(close.float().mean()) >= 0.5, key


def test_two_process_bf16_grads_step_matches_jax(bf16_inputs, bf16_world,
                                                 tmp_path):
    """``BF16_GRADS`` over a mesh of 2 gloo processes, one sample of the
    batch each: each rank forms its gradient in bfloat16, the sum across
    ranks is taken in float32 (``engine/steps.py``), so the averaged
    gradient is not JAX's bf16 sum of the global batch's; it is held to
    JAX's step by ``bf16_judge.bf16_rule`` as the one-process step is
    (the same tensors held, none broken), and both ranks end bit for bit
    equal."""
    variables, raw_batch = bf16_inputs
    cfg, model = _port_model(variables, "bfloat16")
    hm = BF16_SIZE // 4
    r0, r1 = (r["grads"] for r in run_ranks("train_step", 2, tmp_path, dict(
        cfg=cfg._to_plain(), state_dict=model.state_dict(), batch=raw_batch,
        prepare=(2, (BF16_SIZE, BF16_SIZE), (hm, hm)),
        bf16_grads=True)))
    assert all(torch.equal(r0[n], r1[n]) for n in r0)
    ref, f32 = bf16_world["jax"]["grads"], bf16_world["f32"]["grads"]
    held, broken, ratios = bf16_rule(r0, ref, f32)
    assert not broken, {n: ratios[n] for n in broken}
    assert held == bf16_rule(bf16_world["port"]["grads"], ref, f32)[0]


# -- BF16_GRADS judged by ensembles of roundings -------------------------------------


@pytest.fixture(scope="module")
def bf16_ensembles(bf16_inputs, bf16_world):
    """The port's CPU ensemble of the ``BF16_GRADS`` step
    (``bf16_judge.cpu_ensemble``: the nominal step, the nudged steps, the
    held-out control steps), the step whose DCN rounds as the card's, and
    JAX's ensemble (its one compiled step on the batch and on nudged
    copies)."""
    variables, raw_batch = bf16_inputs
    cfg, model = _port_model(variables, "bfloat16")
    f32 = bf16_world["f32"]
    return dict(
        port=J.cpu_ensemble(J.reloaded(model), cfg, _bf16_batch(raw_batch),
                            True),
        card=card_rounded_step(J.reloaded(model), cfg,
                               _bf16_batch(raw_batch), True),
        jax=jax_ensemble(bf16_world["jax_step"], bf16_world["jax_batch"]),
        f32=port_outputs(f32), before=running_stats(f32["before"]))


def _ens_judge(e, cand, ens):
    return J.judge(cand, ens, e["f32"], e["before"])


def test_bf16_grads_ensemble_passes_its_control(bf16_ensembles):
    e = bf16_ensembles
    v = _ens_judge(e, e["port"]["members"][0], e["port"])
    assert v["control"]["broken"] == {}
    assert v["held"] >= 0.6 * v["of"], v["held"]
    assert set(BF16_HELD) <= set(v["named_held"])
    assert _ens_judge(e, e["card"], e["port"])["broken"] == []


def test_jax_bf16_grads_ensemble_holds_the_port(bf16_ensembles):
    e = bf16_ensembles
    v = _ens_judge(e, e["port"]["members"][0], e["jax"])
    assert v["broken"] == [], v["worst"]
    assert v["terms"]["broken"] == [] and v["stats"]["broken"] == []
    assert v["not_bf16"] == []
    assert set(BF16_HELD) <= set(v["named_held"])


def test_the_ports_bf16_grads_ensemble_on_jax(bf16_ensembles):
    e = bf16_ensembles
    v = _ens_judge(e, e["jax"]["members"][0], e["port"])
    assert v["terms"]["broken"] == [] and v["stats"]["broken"] == []
    assert v["not_bf16"] == []
    gap = strays(e["jax"]["members"][0], e["port"], e["f32"], v["broken"])
    assert all(r >= J.BF16_CROSS for r in gap.values()), gap


@pytest.mark.parametrize("fault", J.FAULTS + (J.FINE_FAULT,))
@pytest.mark.parametrize("name", BF16_HELD)
def test_bf16_grads_ensemble_catches_a_planted_fault(bf16_ensembles, name,
                                                     fault):
    """In the control's first step (held out, held by the ensemble), each
    fault breaks the rule at its tensor and nowhere else; x1.25 but where
    the judge is coarser (``BF16_COARSE``)."""
    e = bf16_ensembles
    v = _ens_judge(e, with_fault(e["port"]["controls"][0], name, fault),
                   e["port"])
    caught = fault != J.FINE_FAULT or name not in BF16_COARSE
    assert v["broken"] == ([name] if caught else []), v["faults"]


@pytest.mark.parametrize("name", BF16_HELD)
def test_bf16_grads_ensemble_tells_a_float32_gradient_apart(bf16_ensembles,
                                                            name):
    e = bf16_ensembles
    cand = e["port"]["controls"][0]
    assert _ens_judge(e, cand, e["port"])["not_bf16"] == []
    v = _ens_judge(e, with_f32(cand, e["f32"], name), e["port"])
    assert v["broken"] == [] and v["not_bf16"] == [name]


# -- profiler, metric writer, async checkpoints ----------------------------------

def test_trace_writes_a_trace_or_nothing(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones(8).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(osp.join(d, files[0])) as f:
        assert json.load(f)["traceEvents"]
    with trace(""):
        pass
    with trace(None):
        pass
    assert os.listdir(d) == files
    timer = StepTimer(ema=0.5)
    timer.start()
    assert timer.stop() >= 0 and timer.avg is not None


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_writer_writes_jax_records(tmp_path):
    calls = [("train_loss", 0.5, 1), ("train_acc", np.float32(0.25), 2),
             ("train_acc_avg", torch.tensor(0.125), 0)]
    ours = MetricWriter(str(tmp_path / "port"), use_tensorboard=False)
    theirs = JaxMetricWriter(str(tmp_path / "jax"), use_tensorboard=False)
    for w in (ours, theirs):
        for tag, value, step in calls:
            w.add_scalar(tag, float(value), step)
        w.close()
    got, want = _records(ours.path), _records(theirs.path)
    assert ours.path.endswith("metrics.jsonl")
    assert [set(r) for r in got] == [set(r) for r in want]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "time"}
                        for r in rs]
    assert strip(got) == strip(want)


def _train_cfg(root, **tpu):
    cfg = get_cfg()
    cfg.MODEL.NAME = "FAMIPose"
    cfg.MODEL.EXTRA = TINY_EXTRA
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.PRETRAINED = ""
    cfg.DISTANCE = 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DCN_OFFSET_GROUPS = 4
    cfg.TPU.DCN_MAX_OFFSET = 2
    cfg.TPU.MESH_SHAPE = [1, 1]
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.AUTO_RESUME = True
    cfg.PRINT_FREQ = 1
    cfg.WORKERS = 1
    cfg.OUTPUT_DIR = osp.join(root, "out")
    return cfg


def test_async_save_holds_the_state_at_the_save(tmp_path):
    """The snapshot is taken before ``save_checkpoint`` returns: a step
    taken while the file is written does not reach it; the file resumes."""
    cfg = _train_cfg(str(tmp_path))
    trainer = Trainer(cfg, dataset=SyntheticPoseDataset(4, (64, 64), 4),
                      device="cpu")
    batch = trainer.prepare(next(iter(trainer.loader)))
    trainer.train_step(trainer.state, batch)
    at_save = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    moments = {i: s["exp_avg"].clone() for i, s in
               trainer.state.optimizer.state_dict()["state"].items()}
    path = checkpoints.save_checkpoint(trainer.checkpoints_dir, 0,
                                       trainer.state, async_save=True)
    trainer.train_step(trainer.state, batch)  # moves parameters in place
    checkpoints.wait_for_pending_saves()
    assert not checkpoints._PENDING_SAVES
    saved = checkpoints.load_variables(path)
    assert all(torch.equal(saved[k], at_save[k]) for k in at_save)
    assert not all(torch.equal(at_save[k], v)
                   for k, v in trainer.model.state_dict().items())
    resumed = Trainer(cfg, dataset=SyntheticPoseDataset(4, (64, 64), 4),
                      device="cpu")
    assert resumed.begin_epoch == 1 and resumed.state.step == 1
    got = resumed.model.state_dict()
    assert all(torch.equal(got[k], at_save[k]) for k in at_save)
    opt = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(opt[i]["exp_avg"], m) for i, m in moments.items())


# -- registries and refusals --------------------------------------------------------

def test_core_function_and_model_registries_match_jax():
    for name in ("FAMIPoseFunction", "AlignmentMIFunction_Term6_V1"):
        assert name in CORE_FUNCTION_REGISTRY and name in JAX_CORE_REGISTRY
        assert CORE_FUNCTION_REGISTRY.get(name) is AlignmentMIFunction
    assert sorted(CORE_FUNCTION_REGISTRY.keys()) \
        == sorted(JAX_CORE_REGISTRY.keys())
    for name in ("FAMIPose", "Alignment_V15"):
        assert MODEL_REGISTRY.get(name) is FAMIPose
        assert name in JAX_MODEL_REGISTRY
    assert sorted(MODEL_REGISTRY.keys()) == sorted(JAX_MODEL_REGISTRY.keys())

    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.CORE_FUNCTION = ""
    assert isinstance(build_core_function(cfg), AlignmentMIFunction)
    for c in (cfg, jcfg):
        c.CORE_FUNCTION = "NoSuchFunction"
        c.MODEL.NAME = "NoSuchModel"
    for ours, theirs in ((build_core_function, jax_core.build_core_function),
                         (build_model, jax_build_model)):
        with pytest.raises(KeyError) as got:
            ours(cfg)
        with pytest.raises(KeyError) as want:
            theirs(jcfg)
        assert str(got.value) == str(want.value)
    cfg.MODEL.NAME = "Alignment_V15"
    cfg.MODEL.EXTRA = CfgNode(TINY_EXTRA, new_allowed=True)
    cfg.TPU.REMAT_BACKBONE = True
    model = build_model(cfg, "train")
    assert isinstance(model, FAMIPose) and model.hrnet.remat


def test_what_is_left_is_refused(tmp_path):
    """In one process a mesh of 2 devices raises the JAX package's
    ``ValueError``, on the data axis or the ``model`` axis, in the trainer
    and the evaluator; the evaluator's overlays (``DEBUG.VIS_*``) and the
    levers are not refused."""
    for mesh, error, match in (([2, 1], ValueError, "needs 2 devices"),
                               ([1, 2], ValueError, "needs 2 devices")):
        cfg = _train_cfg(str(tmp_path), MESH_SHAPE=mesh)
        with pytest.raises(error, match=match):
            check_supported(cfg)
        with pytest.raises(error, match=match):
            ev_check(cfg)
    for key in ("VIS_SKELETON", "VIS_BBOX"):
        cfg = _train_cfg(str(tmp_path))
        setattr(cfg.DEBUG, key, True)
        ev_check(cfg)
    cfg = _train_cfg(str(tmp_path), BF16_GRADS=True, REMAT_BACKBONE=True,
                     DEVICE_CROP=True, PROFILE_DIR="/some/dir",
                     ASYNC_CHECKPOINT=True, MESH_SHAPE=[-1, 1])
    check_supported(cfg)
    ev_check(cfg)


# -- every lever at once ---------------------------------------------------------------

def test_trainer_with_every_lever_on(tmp_path, variables):
    """``Trainer.train`` with ``MODEL.PRETRAINED``, ``REMAT_BACKBONE``,
    ``BF16_GRADS`` (bf16 compute), ``DEVICE_CROP`` (raw windows of the
    PoseTrack train split), ``PROFILE_DIR`` (2 of 3 steps traced) and
    ``ASYNC_CHECKPOINT``: the backbone is the file's before the first step,
    every step runs, the trace and ``metrics.jsonl`` are written, and the
    checkpoint resumes."""
    root = str(tmp_path)
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=3,
                                        people_per_frame=2)
    cfg = make_port_cfg(osp.join(root, "json"), img_dir)
    file_vars = random_variables(
        lambda k: JaxFAMIPose(**JAX_KW).init(
            k, jnp.zeros((1, 128, 96, 3)), jnp.zeros((1, 128, 96, 12)),
            train=False), seed=21)
    file_sd = state_dict_from_flax(file_vars)
    path = backbone_pth(osp.join(root, "hrnet.pth"), file_sd)
    base = _train_cfg(root, BF16_GRADS=True, REMAT_BACKBONE=True,
                      DEVICE_CROP=True, DEVICE_CROP_CANVAS=[192, 192],
                      PROFILE_DIR=osp.join(root, "prof"), PROFILE_STEPS=2,
                      ASYNC_CHECKPOINT=True, COMPUTE_DTYPE="bfloat16")
    for section in ("DATASET", "TRAIN"):
        for k, v in getattr(cfg, section).items():
            if k not in ("BATCH_SIZE_PER_GPU", "END_EPOCH", "AUTO_RESUME"):
                getattr(base, section)[k] = v
    base.MODEL.IMAGE_SIZE = [96, 128]
    base.MODEL.HEATMAP_SIZE = [24, 32]
    base.MODEL.PRETRAINED = path
    trainer = Trainer(base, device="cpu")
    assert trainer.steps_per_epoch == 3 and trainer.model.hrnet.remat
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in file_sd.items()
               if k.startswith("hrnet."))
    raw = next(iter(trainer.loader))
    assert raw["kf"].shape[1:] == (192, 192, 3) and "crop_center" in raw
    state = trainer.train()
    assert state.step == 3
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in state.model.parameters())
    traces = os.listdir(osp.join(root, "prof"))
    assert len(traces) == 1
    recs = _records(osp.join(trainer.log_dir, "metrics.jsonl"))
    tags = {r["tag"] for r in recs}
    assert {"train_loss", "train_loss_mse", "train_acc",
            "train_acc_avg"} <= tags
    assert sorted({r["step"] for r in recs if r["tag"] == "train_loss"}) \
        == [1, 2, 3]
    resumed = Trainer(base, device="cpu")
    assert resumed.begin_epoch == 1 and resumed.state.step == 3
    ours, theirs = state.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)



