"""The pieces of the port's train step and one whole step against the JAX
package on the same numpy inputs and the same flax variables.

Tolerances. Losses, heatmap targets and batch preparation: 1e-5 / 1e-6 (a
few f32 operations per element). One whole step at the tiny topology
(f32): loss terms 5e-4 relative + 1e-6; every gradient within 5e-3 of the
largest entry of the whole gradient, plus 2e-3 relative (XLA and torch sum
in other orders; the train-mode BatchNorms, down to B = 2 values per channel
in the offset head, amplify that rounding on the way back to the stem).
On top of that, each gradient tensor at its own scale: its relative L2
distance from the JAX tensor is at most 0.1, and the median over the tensors
at most 5e-3 (measured: worst 1.4e-2 in the stem's bottlenecks, median
4.7e-4). A gradient here is not a continuous function (ReLU masks, the
DCN's clamp gate and integer offsets), so single entries jump with the sum
order, even between thread counts of one package; the L2 distance of a
tensor does not. Tensors whose largest entry is below 2e-5 of the largest
gradient are left out of this: a conv bias before a train-mode BatchNorm
has a true gradient of zero, and what is computed is rounding noise.
The same step over 2 gloo processes, one sample each, is held to the
same bounds, and its two ranks to each other bit for bit.
Post-step parameters: with SGD the max-abs bound times the learning rate;
with Adam, whose first step is ``lr * g / (|g| + 1e-8)``, the port's
parameters first follow that closed form of the port's own gradient to 1e-6;
against JAX, 1e-2 lr wherever both gradients exceed 1e-5 and agree in sign
(outside the tensors of rounding noise named above), which must hold for at least 95% of all entries (measured 99.0%), and 2 lr
elsewhere, plus 1e-6 for the float32 rounding of the parameters themselves.
BatchNorm statistics after the step: 5e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.data.loader import prepare_train_batch as jax_prepare
from fami_pose_tpu.engine.steps import heatmap_pck_accuracy as jax_pck
from fami_pose_tpu.engine.steps import make_train_step as jax_make_train_step
from fami_pose_tpu.engine.train_state import TrainState as JaxTrainState
from fami_pose_tpu.losses.heatmap import fami_total_loss as jax_total_loss
from fami_pose_tpu.losses.heatmap import joint_mse_loss as jax_mse
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.ops.heatmap import generate_heatmaps as jax_generate
from fami_pose_tpu.optim.optimizer import build_lr_schedule as jax_lr_schedule
from fami_pose_tpu.optim.optimizer import build_optimizer as jax_build_optimizer
from fami_pose_torch.config import get_cfg
from fami_pose_torch.data.loader import prepare_train_batch
from fami_pose_torch.engine.steps import heatmap_pck_accuracy, make_train_step
from fami_pose_torch.engine.train_state import TrainState
from fami_pose_torch.losses import build_loss, fami_total_loss, joint_mse_loss
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.ops.heatmap import generate_heatmaps
from fami_pose_torch.optim import build_lr_lambda, build_optimizer
from torch_dist import run_ranks
from torch_port_helpers import nchw, random_variables

JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4, dcn_max_offset=2)


def _hm(a):
    """(B, J, h, w) numpy -> torch; the JAX side takes (B, h, w, J)."""
    return torch.from_numpy(a), jnp.asarray(a.transpose(0, 2, 3, 1))


# -- losses and metrics -------------------------------------------------------

@pytest.mark.parametrize("use_weight,divide", [(True, True), (False, True),
                                               (True, False)])
def test_joint_mse_loss_matches_jax(rng, use_weight, divide):
    p, jp = _hm(rng.randn(3, 5, 6, 4).astype(np.float32))
    t, jt = _hm(rng.rand(3, 5, 6, 4).astype(np.float32))
    w = rng.rand(3, 5).astype(np.float32)
    got = joint_mse_loss(p, t, torch.from_numpy(w), use_weight, divide)
    ref = jax_mse(jp, jt, jnp.asarray(w), use_weight, divide)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_fami_total_loss_matches_jax(rng):
    final, jfinal = _hm(rng.randn(2, 5, 6, 4).astype(np.float32))
    sups = [_hm(rng.randn(2, 5, 6, 4).astype(np.float32)) for _ in range(3)]
    t, jt = _hm(rng.rand(2, 5, 6, 4).astype(np.float32))
    w = (rng.rand(2, 5) > 0.3).astype(np.float32)
    mi = rng.randn(6).astype(np.float32) * 0.01
    total, aux = fami_total_loss(
        final, [s[0] for s in sups], [torch.tensor(v) for v in mi], t,
        torch.from_numpy(w), mse_weight=1.5, mi_alpha=0.4, mi_beta=0.2)
    rtotal, raux = jax_total_loss(
        jfinal, [s[1] for s in sups], list(jnp.asarray(mi)), jt,
        jnp.asarray(w), mse_weight=1.5, mi_alpha=0.4, mi_beta=0.2)
    assert list(aux) == list(raux)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(total) == float(aux["loss"])


def test_build_loss_reads_the_config(rng):
    cfg = get_cfg()
    cfg.LOSS.HEATMAP_MSE.WEIGHT = 2.0
    p, _ = _hm(rng.randn(2, 5, 6, 4).astype(np.float32))
    t, _ = _hm(rng.rand(2, 5, 6, 4).astype(np.float32))
    np.testing.assert_allclose(float(build_loss(cfg)(p, t)),
                               2.0 * float(joint_mse_loss(p, t)), rtol=1e-6)


def test_heatmap_pck_accuracy_matches_jax(rng):
    """Random heatmaps on a non-square map (the axis-swap quirk shows), with
    all-zero targets, targets whose argmax has a coordinate <= 1, and
    predictions moved onto the target's peak."""
    b, j, h, w = 6, 5, 12, 9
    target = rng.rand(b, j, h, w).astype(np.float32)
    pred = rng.rand(b, j, h, w).astype(np.float32)
    target[0, 1] = 0.0
    target[1, 2] = 0.0
    target[1, 2, 1, 5] = 1.5     # argmax y = 1: invalid
    target[2, 3] = 0.0
    target[2, 3, 6, 4] = 2.0
    for bi in range(b):          # half of the predictions on the target
        for ji in range(0, j, 2):
            idx = np.argmax(target[bi, ji])
            pred[bi, ji].reshape(-1)[idx] = 3.0
    got, cnt = heatmap_pck_accuracy(torch.from_numpy(pred),
                                    torch.from_numpy(target))
    ref, rcnt = jax_pck(jnp.asarray(pred.transpose(0, 2, 3, 1)),
                        jnp.asarray(target.transpose(0, 2, 3, 1)))
    assert int(cnt) == int(rcnt)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert 0.0 < float(got) < 1.0
    zero, zcnt = heatmap_pck_accuracy(torch.zeros(2, 3, 4, 4),
                                      torch.zeros(2, 3, 4, 4))
    assert float(zero) == 0.0 and int(zcnt) == 0


# -- targets and batch preparation --------------------------------------------

def test_generate_heatmaps_matches_jax(rng):
    joints = (rng.rand(4, 17, 2) * [80, 110] - [8, 8]).astype(np.float32)
    joints[0, 0] = [-40, 10]       # window off the map: weight 0
    joints[0, 1] = [71.9, 95.9]    # at the far corner
    joints[0, 2] = [-1.0, -1.0]    # truncation toward zero of a negative
    vis = (rng.rand(4, 17) > 0.2).astype(np.float32)
    vis[0, :3] = 1
    got_t, got_w = generate_heatmaps(torch.from_numpy(joints),
                                     torch.from_numpy(vis), 2, (72, 96),
                                     (18, 24))
    ref_t, ref_w = jax_generate(joints, vis, 2, (72, 96), (18, 24))
    assert tuple(got_t.shape) == (4, 17, 24, 18)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    assert got_w[0, 0, 0] == 0 and got_w[0, 1, 0] == 1


def test_prepare_train_batch_matches_jax(rng):
    kf = rng.randint(0, 256, size=(3, 32, 24, 3)).astype(np.uint8)
    sup = rng.randint(0, 256, size=(3, 32, 24, 6)).astype(np.uint8)
    joints = (rng.rand(3, 17, 2) * [24, 32]).astype(np.float32)
    vis = (rng.rand(3, 17) > 0.3).astype(np.float32)
    got = prepare_train_batch(kf, sup, joints, vis, 2, (24, 32), (6, 8))
    ref = jax_prepare(kf, sup, joints, vis, 2, (24, 32), (6, 8))
    assert got["kf"].dtype == torch.float32
    for key in ("kf", "sup", "target"):
        np.testing.assert_allclose(
            got[key].numpy().transpose(0, 2, 3, 1), np.asarray(ref[key]),
            rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))


# -- optimizer and schedule ------------------------------------------------------

def _train_cfg(optimizer="adam", lr=1e-3, second=(None,)):
    cfg = get_cfg()
    cfg.TRAIN.OPTIMIZER = optimizer
    cfg.TRAIN.LR = lr
    cfg.TRAIN.LR_STEP = [2, 3]
    cfg.TRAIN.LR_FACTOR = 0.1
    cfg.TRAIN.MOMENTUM = 0.9
    cfg.TRAIN.LR_SECOND_GROUP = list(second)
    cfg.TRAIN.LR_SECOND_GROUP_VALUE = 1e-5
    return cfg


def test_lr_schedule_matches_jax_at_the_boundaries():
    """Per-step schedule, 5 steps an epoch, milestones at epochs 2 and 3:
    the boundary steps 10 and 15 themselves run at the lower rate."""
    cfg = _train_cfg(lr=0.01)
    ref = jax_lr_schedule(cfg, steps_per_epoch=5)
    lam = build_lr_lambda(cfg, steps_per_epoch=5)
    for step in (0, 9, 10, 11, 14, 15, 16, 40):
        np.testing.assert_allclose(0.01 * lam(step), float(ref(step)),
                                   rtol=1e-6, err_msg=str(step))
    assert lam(9) == 1.0 and lam(10) == pytest.approx(0.1)

    model = torch.nn.Linear(2, 2)
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
    for step in range(17):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(ref(step)), rtol=1e-6)
        opt.step()
        sched.step()


@pytest.fixture(scope="module")
def variables():
    m = JaxFAMIPose(**JAX_KW)
    kf = jnp.zeros((1, 64, 64, 3))
    sup = jnp.zeros((1, 64, 64, 12))
    return random_variables(lambda k: m.init(k, kf, sup, train=False), seed=7)


PORT_KW = dict(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
               feat_hw=(16, 16), dcn_offset_groups=4, dcn_max_offset=2,
               warp_max_shift=26)


def _port_model(variables):
    m = FAMIPose(**PORT_KW)
    m.load_state_dict(state_dict_from_flax(variables))
    return m.train()


def test_second_parameter_group_matches_jax(variables):
    """Plain SGD on unit gradients shows each leaf's learning rate; the JAX
    tree of rates, carried over by the bridge, is held against the port's
    parameter groups. ``hrnet.final_layer`` is scoped outside ``hrnet`` in
    the JAX tree, and follows the main group there and here."""
    cfg = _train_cfg("sgd", lr=1e-2, second=("hrnet", "dcn_offset"))
    cfg.TRAIN.MOMENTUM = 0.0
    params = variables["params"]
    tx = jax_build_optimizer(cfg, steps_per_epoch=5)
    ones = jax.tree.map(jnp.ones_like, params)
    updates, _ = tx.update(ones, tx.init(params), params)
    rates = state_dict_from_flax(
        {"params": jax.tree.map(lambda u: -np.asarray(u), updates)})

    model = _port_model(variables)
    opt, _ = build_optimizer(cfg, model, steps_per_epoch=5)
    assert [g["lr"] for g in opt.param_groups] == [1e-2, 1e-5]
    lr_of = {id(p): g["lr"] for g in opt.param_groups for p in g["params"]}
    seen = set()
    for name, p in model.named_parameters():
        want = float(rates[name].flatten()[0])
        assert lr_of[id(p)] == pytest.approx(want, rel=1e-6), name
        seen.add(want > 1e-3)
    assert seen == {True, False}
    assert lr_of[id(model.hrnet.final_layer.weight)] == 1e-2
    assert lr_of[id(model.hrnet.conv1.weight)] == 1e-5
    assert lr_of[id(model.dcn_offset_2.conv.weight)] == 1e-5
    assert lr_of[id(model.dcn_2.weight)] == 1e-2


# -- one whole train step ---------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(5)
    kf = rs.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    sup = rs.randint(0, 256, size=(2, 64, 64, 12)).astype(np.uint8)
    joints = (rs.rand(2, 17, 2) * 64).astype(np.float32)
    vis = (rs.rand(2, 17) > 0.2).astype(np.float32)
    return kf, sup, joints, vis


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    """The JAX side, compiled twice only (interpret-mode Pallas is slow to
    compile): one Adam step of the package's own ``make_train_step`` with
    the Pallas DCN forward and backward, as the configured train path runs
    it; and loss terms and gradients of the same loss through the XLA DCN
    (the two backwards agree away from integer offsets, which f32 random
    offsets are). The SGD step is the package's optimizer applied to those
    gradients."""
    jb = jax_prepare(*batch, 2, (64, 64), (16, 16))
    params, stats = variables["params"], variables["batch_stats"]

    def new_state(tx):
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=stats, opt_state=tx.init(params),
                             tx=tx)

    pallas_model = JaxFAMIPose(use_pallas_dcn=True, **JAX_KW)
    adam = jax_build_optimizer(_train_cfg("adam"), steps_per_epoch=5)
    adam_state, metrics = jax_make_train_step(pallas_model, donate=False)(
        new_state(adam), jb)

    xla_model = JaxFAMIPose(use_pallas_dcn=False, **JAX_KW)

    def loss_fn(p):
        (final, sup_hms, _, mi), _ = xla_model.apply(
            {"params": p, "batch_stats": stats}, jb["kf"], jb["sup"],
            train=True, mutable=["batch_stats"])
        return jax_total_loss(final, sup_hms, mi, jb["target"],
                              jb["target_weight"])

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    sgd = jax_build_optimizer(_train_cfg("sgd"), steps_per_epoch=5)
    sgd_state = new_state(sgd).apply_gradients(grads)
    return {
        "aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "adam": adam_state.params, "sgd": sgd_state.params,
        "batch_stats": adam_state.batch_stats,
    }


def _grad_tol(grads):
    scale = max(float(g.abs().max()) for g in grads.values())
    return 5e-3 * scale


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_step_matches_jax(variables, batch, jax_step, optimizer):
    cfg = _train_cfg(optimizer)
    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
    state = TrainState(model, opt, sched)
    pb = prepare_train_batch(*batch, 2, (64, 64), (16, 16))
    state, metrics = make_train_step()(state, pb)
    assert state.step == 1
    _check_step_against_jax(
        model.state_dict(), {n: p.grad for n, p in model.named_parameters()},
        metrics, before, jax_step, optimizer, float(cfg.TRAIN.LR))
    assert opt.param_groups[0]["lr"] == pytest.approx(float(cfg.TRAIN.LR))


@pytest.mark.parametrize("remat,mesh_shape,world", [
    (False, [-1, 1], 2), (True, [-1, 1], 2), (False, [1, 2], 2),
    (False, [2, 2], 4)], ids=["plain", "remat", "model-axis", "two-by-two"])
def test_two_process_train_step_matches_jax(variables, batch, jax_step, remat,
                                            mesh_shape, world, tmp_path):
    """The same global batch of 2 over a mesh of gloo processes
    (``tests/torch_dist.py``): ``[-1, 1]``, one sample a rank; ``[1, 2]``,
    both ranks the whole batch; ``[2, 2]``, one sample a data index and
    two ranks each. BatchNorm's statistics and the gradients are the
    global batch's (a model axis counts each data index's sums, count and
    gradient ``m`` times over, and the PCK counts are scaled by the data
    axis to match), so the Adam step meets the bounds of the one-process
    step against the JAX step above, metrics included, and every rank ends
    bit for bit equal (parameters, gradients, statistics, Adam's moments,
    metrics). With ``REMAT_BACKBONE`` the recomputed backbone issues its
    BatchNorms' all-reduces again inside the backward."""
    cfg = _train_cfg("adam")
    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ranks = run_ranks("train_step", world, tmp_path, dict(
        model_kw=PORT_KW, state_dict=model.state_dict(), cfg=cfg._to_plain(),
        batch=batch, prepare=(2, (64, 64), (16, 16)), remat=remat,
        mesh_shape=mesh_shape))
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("state_dict", "grads", "metrics"):
            assert list(r0[key]) == list(r[key])
            for k in r0[key]:
                assert torch.equal(r0[key][k], r[key][k]), (key, k)
        m0, m1 = r0["optimizer"]["state"], r["optimizer"]["state"]
        assert all(torch.equal(m0[i][k], m1[i][k]) for i in m0
                   for k in m0[i])
    _check_step_against_jax(r0["state_dict"], r0["grads"], r0["metrics"],
                            before, jax_step, "adam", float(cfg.TRAIN.LR))


def _check_step_against_jax(got, port_grads, metrics, before, jax_step,
                            optimizer, lr):
    """The port's state, gradients and metrics after one step against the
    JAX step's, by the bounds of the module docstring."""
    ref_metrics = jax_step["metrics"]
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        tol = dict(rtol=5e-4, atol=1e-6) if k.startswith("loss") else dict(
            atol=1e-6)
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **tol)
    for k, v in jax_step["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=5e-4, atol=1e-6)

    # every gradient (left on the parameters by the step)
    ref_grads = state_dict_from_flax({"params": jax.tree.map(
        np.asarray, jax_step["grads"])})
    atol = _grad_tol(ref_grads)
    names = list(port_grads)
    assert set(names) == set(ref_grads)
    for name, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                   rtol=2e-3, atol=atol, err_msg=name)
    floor = 2e-5 * max(float(g.abs().max()) for g in ref_grads.values())
    rel_l2 = {name: float((g - ref_grads[name]).norm()
                          / ref_grads[name].norm())
              for name, g in port_grads.items()
              if float(ref_grads[name].abs().max()) > floor}
    assert len(rel_l2) >= 0.95 * len(names)
    worst = max(rel_l2, key=rel_l2.get)
    assert rel_l2[worst] <= 0.1, (worst, rel_l2[worst])
    assert float(np.median(list(rel_l2.values()))) <= 5e-3

    # post-step parameters and BatchNorm statistics
    want = state_dict_from_flax({
        "params": jax.tree.map(np.asarray, jax_step[optimizer]),
        "batch_stats": jax.tree.map(np.asarray, jax_step["batch_stats"])})
    assert set(got) == set(want)
    moved = sure_entries = entries = 0
    for key, ref in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), ref.numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=key)
            continue
        diff = (got[key] - ref).abs()
        if optimizer == "sgd":
            bound = lr * (atol + 2e-3 * ref_grads[key].abs()) + 1e-7
        else:
            g, g_ref = port_grads[key], ref_grads[key]
            closed_form = before[key] - lr * g / (g.abs() + 1e-8)
            assert bool(((got[key] - closed_form).abs() <= 1e-6).all()), key
            sure = ((g_ref.abs() > 1e-5) & (g.abs() > 1e-5)
                    & (torch.sign(g) == torch.sign(g_ref))
                    & (key in rel_l2))  # not in a tensor of rounding noise
            sure_entries += int(sure.sum())
            entries += sure.numel()
            bound = torch.where(sure, torch.tensor(1e-2 * lr),
                                torch.tensor(2 * lr))
        # + 1e-6: the parameters are O(1) float32 values, a few ulps each
        assert bool((diff <= bound + 1e-6).all()), key
        moved += int(not torch.equal(got[key], before[key]))
    assert moved > 100
    if optimizer == "adam":
        assert sure_entries >= 0.95 * entries, (sure_entries, entries)
