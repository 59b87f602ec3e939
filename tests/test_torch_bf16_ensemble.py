"""The shipped bf16 train step (``TPU.COMPUTE_DTYPE bfloat16`` with
``TPU.BF16_GRADS`` off, the flagship YAML) judged by an ensemble of CPU
roundings (``fami_pose_torch/tools/bf16_judge.py``), the port against the
JAX package at the tiny topology (``TINY_EXTRA``) on the CPU.

Set-up. 128x128 inputs, not the 64x64 of ``tests/test_torch_bf16_parity.py``:
at 64x64 the offset head's last conv takes a 1x1 map, and the CPU
library's bf16 weight gradient of it came back non-finite in one of three
runs of the port's shipped step here (as ``test_torch_train_levers.py``
found for ``BF16_GRADS``). The seeded weights of the parity tests
(``random_variables``, seed 7) tamed as ``test_torch_train_levers.py``'s
``tame_variables`` does (BatchNorm scale 0.1 / shift 1, the head's kernels
halved): on the untamed weights the step is chaotic, and the ensemble
holds 17 of 255 gradient tensors, none of ``BF16_HELD``. One JAX compile
of ``make_train_step(..., bf16_grads=False)`` with
``xla_allow_excess_precision`` off (XLA rounds where the program casts;
compiled as configured it keeps fused values in f32, so that 235 of 255
gradients are not bf16 values) and the JAX DCN's XLA form
(``TPU.USE_PALLAS_DCN False``, the same function as the Pallas kernel: the
interpret-mode Pallas compile alone took 128 s here), run on the batch and
on ``bf16_judge.NUDGE_SEEDS`` nudged copies of it. The port: its f32 step,
its ensemble (the nominal step, a nudged step a seed; the control's nudged
steps of ``CONTROL_SEEDS`` held out) and, judged as a candidate, the step
whose plain DCN rounds the sampled column to bf16 as the card's kernels do
(``torch_bf16_ensemble.card_rounding``), each without the parameters'
update, which nothing reads.

Tolerances: the judge's own (``BF16_TAME`` 0.2, ``BF16_CROSS`` 3,
``BF16_SCALE`` 2^-6; L2 per gradient tensor in float64, absolute per loss
term, max-abs per running statistic with the f32 step's move for scale).

What holds, measured here:

* the control: each held-out nudged step, judged by the port's ensemble,
  breaks no held gradient, loss term or statistic (188 of 255 gradients
  held, ``bf16_rule`` with JAX for reference holds 148; worst ratio 0.66);
  the DCN-column step lies inside (at most 0.18);
* JAX's ensemble (its nominal run and its nudged runs of the one compile)
  holds the port's step: no held gradient (136 of 255 held; worst 0.46),
  loss term or running statistic broken, and no held gradient that is a
  bf16 value in every JAX run fails to be one in the port's;
* the port's ensemble holds JAX's loss terms and running statistics. Of
  JAX's gradients it breaks 33 of the 188 held: on each JAX's own gap to
  the f32 step is 4.7 to 753 times the largest gap of a port rounding
  (asserted: at least ``BF16_CROSS``), so JAX's arithmetic strays from
  f32, not the port's. One cause is shown below: XLA's CPU backend sums
  the transpose of a bf16 broadcast (a bias's gradient) in bf16, one
  rounding an addition, where torch (and a card) sums in f32 and rounds
  once;
* a fault planted in the control's first step at a ``BF16_HELD`` tensor,
  x2, x0 or x-1, breaks the rule there and nowhere else; x1.25 too, but at
  the stem conv, where the judge's sharpness is x1.5 (``COARSE``: its
  spread is 10% of its gradient); the other four reach 1 + 2^-3 to
  1 + 2^-5;
* a gradient taken from the f32 step, not the bf16 one, at a held conv
  of ``BF16_HELD`` is named by the judge (``not_bf16``), though the norm
  rule passes it (the offset head's dense layers form their gradients in
  float32 in every member, so none is expected there).

On synthetic outputs (no step), the judge's own rules: the ensemble grows
while a held-out control breaks and not for a candidate that breaks; the
faults go into the held tensors of the largest gradient where no named
one is held; a verdict that holds fewer tensors than ``HELD_FLOOR`` of
them fails.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fami_pose_tpu.config import get_cfg as jax_get_cfg
from fami_pose_tpu.data import loader as jax_loader
from fami_pose_tpu.engine.steps import make_train_step as jax_make_train_step
from fami_pose_tpu.engine.train_state import TrainState as JaxTrainState
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.optim.optimizer import build_optimizer as jax_build_optimizer
from fami_pose_torch.config import get_cfg
from fami_pose_torch.config.node import CfgNode
from fami_pose_torch.data.loader import prepare_train_batch
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.tools import bf16_judge as J
from test_torch_train_levers import tame_variables
from torch_bf16_ensemble import (
    card_rounded_step, jax_ensemble, jax_outputs, running_stats, strays,
    with_f32, with_fault,
)
from torch_port_helpers import random_variables

SIZE = 128
B, NUM_SUP = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(dtype):
    """The flagship YAML at the tiny topology, on both packages' configs."""
    hm = SIZE // 4
    args = types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["MODEL.IMAGE_SIZE", [SIZE, SIZE], "MODEL.HEATMAP_SIZE", [hm, hm],
              "TPU.COMPUTE_DTYPE", dtype, "TPU.DCN_MAX_OFFSET", 2,
              "TPU.DCN_OFFSET_GROUPS", 4, "TPU.USE_PALLAS_DCN", False])
    port, ref = get_cfg(args), jax_get_cfg(args)
    port.MODEL.EXTRA = CfgNode(TINY_EXTRA, new_allowed=True)
    ref.MODEL.EXTRA = TINY_EXTRA
    return port, ref


@pytest.fixture(scope="module")
def world():
    """JAX's ensemble, the port's ensemble and the port's f32 step, from
    the same tame weights and batch."""
    hm = SIZE // 4
    init = JaxFAMIPose(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
                       dcn_offset_groups=4)
    variables = tame_variables(random_variables(
        lambda k: init.init(k, jnp.zeros((1, SIZE, SIZE, 3)),
                            jnp.zeros((1, SIZE, SIZE, 3 * NUM_SUP)),
                            train=False), seed=7))
    rs = np.random.RandomState(5)
    raw = (rs.randint(0, 256, size=(B, SIZE, SIZE, 3)).astype(np.uint8),
           rs.randint(0, 256, size=(B, SIZE, SIZE, 3 * NUM_SUP)
                      ).astype(np.uint8),
           (rs.rand(B, 17, 2) * SIZE).astype(np.float32),
           (rs.rand(B, 17) > 0.2).astype(np.float32))
    _, jcfg = _cfgs("bfloat16")
    model = JaxFAMIPose.from_config(jcfg)
    assert model.dtype == jnp.bfloat16 and not model.use_pallas_dcn
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
    jb = jax_loader.prepare_train_batch(*raw, B, (SIZE, SIZE), (hm, hm))
    compiled = jax_make_train_step(model, donate=False, bf16_grads=False
                                   ).lower(state, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jax_ens = jax_ensemble(lambda b: jax_outputs(*compiled(state, b)), jb)
    sd = state_dict_from_flax(variables)

    def model(dtype):
        cfg, _ = _cfgs(dtype)
        m = FAMIPose.from_config(cfg)
        m.load_state_dict(sd)
        return cfg, m.train()

    batch = prepare_train_batch(*raw, B, (SIZE, SIZE), (hm, hm))
    cfg32, m32 = model("float32")
    cfg16, m16 = model("bfloat16")
    return dict(jax=jax_ens,
                f32=J.step_outputs(m32, cfg32, batch, update=False),
                port=J.cpu_ensemble(J.reloaded(m16), cfg16, batch),
                card=card_rounded_step(J.reloaded(m16), cfg16, batch),
                before=running_stats(sd))


def _judge(world, cand, ens, names=J.BF16_HELD):
    return J.judge(cand, ens, world["f32"], world["before"], names=names)


def test_the_ports_ensemble_passes_its_control(world):
    v = _judge(world, world["port"]["members"][0], world["port"])
    assert v["control"]["broken"] == {}
    assert v["held"] >= 0.6 * v["of"], v["held"]
    assert set(J.BF16_HELD) <= set(v["named_held"])
    # the step that rounds as the card's DCN does lies well inside
    assert _judge(world, world["card"], world["port"])["broken"] == []


def test_jax_ensemble_holds_the_port(world):
    v = _judge(world, world["port"]["members"][0], world["jax"])
    assert v["broken"] == [], v["worst"]
    assert v["terms"]["broken"] == [] and v["stats"]["broken"] == []
    assert v["not_bf16"] == []
    assert v["held"] >= 0.5 * v["of"], v["held"]
    assert {"dcn_1.weight", "dcn_mask_1.conv.weight"} <= set(v["named_held"])


def test_the_ports_ensemble_on_jax(world):
    v = _judge(world, world["jax"]["members"][0], world["port"])
    assert v["terms"]["broken"] == [] and v["stats"]["broken"] == []
    assert v["terms"]["held"] == v["terms"]["of"]
    gap = strays(world["jax"]["members"][0], world["port"], world["f32"],
                 v["broken"])
    assert all(r >= J.BF16_CROSS for r in gap.values()), gap
    # bf16 values where the port's are, but in two held tensors whose
    # gradients (a BatchNorm's shift and a dense layer's bias of the offset
    # head) XLA forms outside a bf16 cast
    assert len(v["not_bf16"]) <= 2, v["not_bf16"]


def test_xla_cpu_sums_a_bf16_bias_gradient_in_bf16():
    """The gradient of a bias broadcast-added in bf16 (2048 terms of mean
    3): XLA's CPU backend sums it in bf16, one rounding an addition (67%
    off, measured here); torch sums in f32 and rounds once, as
    ``jnp.sum`` does (0.24%, one bf16 rounding)."""
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(2, 32, 32, 17) + 3.0, jnp.bfloat16)
    exact = np.asarray(x, np.float64).sum(axis=(0, 1, 2))

    def loss(b):
        y = jnp.zeros(x.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum(y * x).astype(jnp.float32)

    zero = jnp.zeros(17, jnp.float32)
    grad = jax.jit(jax.grad(loss)).lower(zero).compile(
        compiler_options={"xla_allow_excess_precision": False})(zero)
    summed = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().sum(
        dim=(0, 1, 2))

    def err(a):
        return float(np.abs(np.asarray(a, np.float64) - exact).max()
                     / np.abs(exact).max())

    assert err(summed.double().numpy()) <= 2.0 ** -8
    assert err(grad) >= 0.1


def _control(world):
    """The control's first candidate (a held-out nudged step) and the
    port's ensemble, which holds it."""
    return world["port"]["controls"][0], world["port"]


# the judge's sharpness where it is coarser than FINE_FAULT (measured here:
# the stem conv's spread is 10% of its gradient, so the bound is 0.3 of it)
COARSE = {"hrnet.conv1.weight": 1.5}


@pytest.mark.parametrize("fault", J.FAULTS + (J.FINE_FAULT,))
@pytest.mark.parametrize("name", J.BF16_HELD)
def test_a_planted_fault_breaks_the_rule_at_its_tensor(world, name, fault):
    """Doubled, zeroed, sign-flipped: caught at the tensor and nowhere
    else; x1.25 too, but where the judge is coarser (``COARSE``)."""
    cand, ens = _control(world)
    v = _judge(world, with_fault(cand, name, fault), ens)
    caught = fault != J.FINE_FAULT or name not in COARSE
    assert v["broken"] == ([name] if caught else []), v["faults"]


@pytest.mark.parametrize("name", J.BF16_HELD)
def test_the_judges_sharpness(world, name):
    cand, ens = _control(world)
    assert _judge(world, cand, ens)["sharpness"][name] <= COARSE.get(
        name, J.FINE_FAULT)


# the held tensors of BF16_HELD whose gradients the shipped step forms in
# bf16: the offset head's dense layers take theirs in float32 (every member)
DENSE = "feat_global_offset_layers.8.weight"


def test_the_offset_heads_dense_gradient_is_float32(world):
    ens = world["port"]
    assert not any(J.bf16_valued(m["grads"][DENSE])
                   for m in ens["members"] + ens["controls"])


@pytest.mark.parametrize("name", [n for n in J.BF16_HELD if n != DENSE])
def test_a_float32_gradient_is_told_apart(world, name):
    cand, ens = _control(world)
    assert _judge(world, cand, ens)["not_bf16"] == []
    v = _judge(world, with_f32(cand, world["f32"], name), ens)
    assert v["broken"] == [] and v["not_bf16"] == [name]


# -- the judge's own rules, on synthetic outputs (no step) -----------------------


def _synthetic(rs, n=64, size=100, spread=0.01, wide=()):
    """f32 gradients of ``n`` tensors, the nominal member ``spread`` of a
    unit away from them, and a function of a member ``spread`` from the
    nominal one (``wide``: tensors where it lies ten times the nominal
    one's size away)."""
    f32 = {f"t{i}": torch.from_numpy(rs.randn(size) * (1 + i))
           for i in range(n)}
    c = {k: v + spread * torch.from_numpy(rs.randn(size))
         for k, v in f32.items()}

    def member(wide=wide):
        return dict(terms={}, stats={}, grads={
            k: 11 * v if k in wide else v + spread * torch.from_numpy(
                rs.randn(size)) for k, v in c.items()})
    return dict(terms={}, stats={}, grads=f32), dict(terms={}, stats={},
                                                      grads=c), member


def _ensemble(nominal, member, controls):
    return dict(members=[nominal] + [member() for _ in J.NUDGE_SEEDS],
                labels=["nominal"] + [f"nudged {s}" for s in J.NUDGE_SEEDS],
                controls=controls, control_labels=["nudged 4", "nudged 5"],
                seconds=[])


def test_the_ensemble_grows_while_a_control_breaks(monkeypatch):
    """A control far out at one tensor grows the ensemble, one nudged step
    at a time, until it passes; a candidate far out does not: the
    ensemble is settled by its controls before a candidate is judged."""
    rs = np.random.RandomState(0)
    f32, nominal, member = _synthetic(rs)
    added = iter([member(), member(wide=("t3",))])
    monkeypatch.setattr(J, "step_outputs", lambda *a, **k: next(added))
    batch = {k: torch.zeros(1, 2) for k in ("kf", "sup")}
    ens = _ensemble(nominal, member, [member(wide=("t3",)), member()])
    assert J.judge(nominal, ens, f32, {})["control"]["broken"] == {
        "nudged 4": {"grads": ["t3"]}}
    assert J.grow(ens, f32, {}, lambda: None, None, batch) == [6, 7]
    v = J.judge(member(wide=("t5",)), ens, f32, {})
    assert v["control"]["broken"] == {} and v["broken"] == ["t5"]
    assert not v["ok"]
    ens = _ensemble(nominal, member, [member(), member()])
    assert J.grow(ens, f32, {}, lambda: None, None, batch) == []
    assert len(ens["members"]) == 1 + len(J.NUDGE_SEEDS)


def test_faults_go_to_the_largest_held_tensors_where_none_named_is():
    rs = np.random.RandomState(1)
    f32, nominal, member = _synthetic(rs)
    ens = _ensemble(nominal, member, [member(), member()])
    v = J.judge(member(), ens, f32, {})
    assert v["ok"] and v["named_held"] == []
    largest = sorted(f32["grads"],
                     key=lambda k: -float(f32["grads"][k].norm()))
    assert v["faults_at"] == largest[:J.FAULT_FALLBACK]
    assert len(v["faults"]) == 3 * (len(J.FAULTS) + 1)
    assert v["faults_missed"] == []


@pytest.mark.parametrize("held", [0, 1, 16])
def test_a_verdict_below_the_held_floor_fails(held):
    """Of 1024 tensors, the floor is 16 (``HELD_FLOOR`` 1/64): 16 held
    pass, fewer fail, whatever else holds."""
    rs = np.random.RandomState(2)
    f32, nominal, member = _synthetic(rs, n=1024, size=8, spread=0.001)
    unheld = [f"t{i}" for i in range(held, 1024)]
    ens = _ensemble(nominal, lambda: member(wide=unheld),
                    [member(), member()])
    v = J.judge(member(), ens, f32, {})
    assert (v["held"], v["held_floor"]) == (held, 16)
    assert v["broken"] == [] and v["control"]["broken"] == {}
    assert v["ok"] == (held >= 16)
