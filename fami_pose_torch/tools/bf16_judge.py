"""The judge of a bfloat16 train step's gradients: is a candidate step (the
card's, or another package's) one more valid rounding of the port's bf16
step, or is it wrong?

A bf16 train step of a deep network with train-mode BatchNorm is chaotic:
two equally valid roundings of one step (another order of a conv's sums,
an input cast that rounds the other way) give gradients that lie far
apart in many tensors. So no fixed tolerance fits, and the gap of one
rounding to the f32 step (:func:`bf16_rule`) is one sample of a spread
that can be several times wider. :func:`judge` measures the spread itself,
per tensor, from an ensemble of the port's own bf16 step on the CPU
(:func:`cpu_ensemble`: plain kernels, the same weights and batch; only the
rounding differs):

* the nominal member ``c``: the step on the batch as given;
* nudged members, one a seed: the step with every frame element scaled by
  ``1 + s 2^-9``, s = +-1 drawn per element from a numpy seed
  (:func:`nudged`): half a bf16 ulp, so that about half of the elements
  round to the neighbouring bf16 value at the model's input cast.

For each gradient tensor n, with f the f32 step's gradient, ``spread(n)``
is the largest of |c - f| and |m - c| over the members (L2, in float64).
The tensor is held where ``spread(n) <= BF16_TAME |f|``, and there a
candidate g passes where ``|g - c| <= BF16_CROSS spread(n) + BF16_SCALE
|f|``. The loss terms take the same rule in absolute value, and the
running statistics in max-abs with the f32 step's move of each statistic
for scale. The judge keeps itself honest:

* the control: nudged steps of other seeds, held out of the ensemble and
  each judged by it as the candidate is, break no held key. While a
  control breaks, :func:`grow` adds nudged steps one at a time (up to
  ``GROW_SEEDS``): a tensor whose roundings spread with a long tail needs
  more members to show its spread. The controls alone settle the
  ensemble, before any candidate is judged by it, so a candidate's own
  result never widens its bound. Leaving one member out of the ensemble
  instead misfires where a gradient takes one of two values: a member
  alone in the rarer one breaks the rule against the rest, however many
  members there are (on the card the offset head's last biases did so);
* at least a share ``HELD_FLOOR`` of the gradient tensors is held;
* planted faults: the candidate's gradient of each held named tensor
  (``BF16_HELD`` by default), or where none is held, of the
  ``FAULT_FALLBACK`` held tensors with the largest f32 gradient, doubled,
  zeroed or sign-flipped breaks the rule at that tensor; the finer
  ``FINE_FAULT`` (x1.25) is read beside the judge's sharpness there, the
  smallest factor ``1 + 2^-k`` still caught;
* a held gradient formed in float32 where every member's is a bf16 value
  is named (``not_bf16``): a norm cannot tell it from a bf16 one, since
  the f32 gradient lies within the spread by construction.

Imports torch and numpy; the port's step, model pieces and optimizer are
imported where they are used.
"""

import math
import time

import numpy as np
import torch

# the rule for a bf16 gradient tensor against a reference's
# (tests/test_torch_train_levers.py holds the port against JAX with it, and
# chip_smoke.py's phase train-levers the card against the port on the CPU):
# a tensor is held where the reference's own gap to the f32 step is at most
# BF16_TAME of the f32 gradient (L2), and there |got - ref| <= BF16_CROSS
# |ref - f32| + BF16_SCALE |f32|; the same bound holds the loss terms, and
# the running statistics in max-abs with the f32 step's move for scale. The
# step runs on tame weights (chip_smoke.tame_weights), where a bf16 step is
# not chaotic; BF16_HELD must be held, and a fault planted in any of them
# must break the rule there
BF16_TAME = 0.2
BF16_CROSS = 3.0
BF16_SCALE = 2.0 ** -6
BF16_HELD = ("dcn_1.weight", "dcn_offset_1.conv.weight",
             "dcn_mask_1.conv.weight", "feat_global_offset_layers.8.weight",
             "hrnet.conv1.weight")


def bf16_rule(got, ref, f32):
    """The per-tensor rule of ``got``'s bf16 gradients against ``ref``'s:
    the tensors held (``ref``'s own gap to ``f32`` at most ``BF16_TAME`` of
    the f32 gradient, in L2), those of them that break ``|got - ref| <=
    BF16_CROSS |ref - f32| + BF16_SCALE |f32|``, and each held tensor's
    ``|got - ref|`` over that bound."""
    held, broken, ratios = [], [], {}
    for n, f in f32.items():
        f = f.double()
        size = float(f.norm())
        own = float((ref[n].double() - f).norm())
        if size == 0 or own > BF16_TAME * size:
            continue
        held.append(n)
        ratios[n] = float((got[n].double() - ref[n].double()).norm()) / (
            BF16_CROSS * own + BF16_SCALE * size)
        if ratios[n] > 1.0:
            broken.append(n)
    return held, broken, ratios


def planted_faults(got, ref, f32):
    """``bf16_rule`` on ``got`` with one held ``BF16_HELD`` tensor
    doubled, zeroed or sign-flipped at a time: the ratio each fault reaches,
    and the faults that did not break the rule there alone."""
    reached, missed = {}, []
    held = bf16_rule(got, ref, f32)[0]
    for name in (n for n in BF16_HELD if n in held):
        for fault in (2.0, 0.0, -1.0):
            planted = dict(got, **{name: fault * got[name]})
            _, broken, ratios = bf16_rule(planted, ref, f32)
            reached[f"{name} x {fault}"] = ratios.get(name)
            if broken != [name]:
                missed.append((name, fault, broken[:3]))
    return reached, missed


# -- the ensemble ---------------------------------------------------------------

NUDGE = 2.0 ** -9
NUDGE_SEEDS = (1, 2, 3)
# nudged steps held out of the ensemble, each judged by it: the control
CONTROL_SEEDS = (4, 5)
# nudged steps added to the ensemble, one at a time, while a control
# breaks a held key (:func:`grow`; with three nudges a held-out control
# broke once, at 1.07 of its bound, at full W48 depth on a trained
# checkpoint)
GROW_SEEDS = (6, 7, 8, 9)
FAULTS = (2.0, 0.0, -1.0)
# a finer fault, read with the sharpness: where the spread nears BF16_TAME
# the bound nears 0.6 |f32|, and no fault under that shows
FINE_FAULT = 1.25
# sharpness: the factors 1 + 2^-k, k = 1 .. SHARPNESS_K, tried in turn
SHARPNESS_K = 12
QUANTILES = (0.5, 0.9, 1.0)
# the least share of the gradient tensors a verdict must hold, below which
# it fails: about half the least seen at full W48 depth on a trained
# checkpoint (33 of 984 there, so 16 of 984; 18 held on a converged one)
HELD_FLOOR = 1 / 64
# where no named tensor is held, the faults go into this many held tensors,
# those of the largest f32 gradient
FAULT_FALLBACK = 3


def nudged(batch, seed, keys=("kf", "sup")):
    """``batch`` with each element of its frames scaled by ``1 + s NUDGE``,
    s = +-1 drawn per element from ``np.random.RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    out = dict(batch)
    for k in keys:
        s = rs.randint(0, 2, size=tuple(batch[k].shape)) * 2 - 1
        factor = torch.from_numpy(1 + s * NUDGE).to(batch[k].dtype)
        out[k] = batch[k] * factor.to(batch[k].device)
    return out


class NoUpdate:
    """An optimizer and a schedule that leave the parameters as they are:
    a member's gradients, loss terms and running statistics are formed
    before the update, which the judge does not read (Adam's update took
    a third of the CPU time of a W48 bf16 step on the CPU)."""

    def __init__(self, model):
        self.params = list(model.parameters())

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def step_outputs(model, cfg, batch, bf16_grads=False, update=True):
    """One train step (``engine/steps.py::make_train_step``) of ``model``
    (in train mode, changed in place) on ``batch``, on the device of both:
    its loss terms, its gradients and its BatchNorms' running statistics
    after the step, on the CPU. ``update`` False skips the optimizer's
    update of the parameters (:class:`NoUpdate`); otherwise Adam as
    configured."""
    from ..engine.steps import make_train_step
    from ..engine.train_state import TrainState
    from ..optim import build_optimizer

    if update:
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
    else:
        opt = sched = NoUpdate(model)
    _, metrics = make_train_step(bf16_grads=bf16_grads)(
        TrainState(model, opt, sched), batch)
    return dict(
        terms={k: float(v) for k, v in metrics.items()
               if k.startswith("loss")},
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()
               if p.grad is not None},
        stats={k: v.detach().cpu().clone()
               for k, v in model.state_dict().items() if "running_" in k})


def reloaded(model):
    """A function that returns ``model`` with the state it has now (the
    running statistics a step changes included), for one member after
    another without building the model anew."""
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def make():
        model.load_state_dict(state)
        return model.train()
    return make


def cpu_ensemble(make_model, cfg, batch, bf16_grads=False,
                 seeds=NUDGE_SEEDS, control_seeds=CONTROL_SEEDS):
    """The ensemble of the port's bf16 step on the CPU, without the
    optimizer's update: ``make_model()`` returns the model on the CPU with
    the weights under test (:func:`reloaded`), ``cfg`` its bf16 config,
    ``batch`` the CPU batch. ``members``: the nominal step and one nudged
    step a seed of ``seeds``; ``controls``: one nudged step a seed of
    ``control_seeds``, held out of the ensemble for the control. Returns
    ``dict(members, labels, controls, control_labels, seconds)``."""
    runs = [("members", "nominal", batch)]
    runs += [("members", f"nudged {s}", nudged(batch, s)) for s in seeds]
    runs += [("controls", f"nudged {s}", nudged(batch, s))
             for s in control_seeds]
    out = dict(members=[], labels=[], controls=[], control_labels=[],
               seconds=[])
    for part, label, b in runs:
        t0 = time.perf_counter()
        out[part].append(step_outputs(make_model(), cfg, b, bf16_grads,
                                      update=False))
        out["labels" if part == "members" else "control_labels"].append(
            label)
        out["seconds"].append(time.perf_counter() - t0)
    return out


def _l2(a, b=None):
    d = a.double() if b is None else a.double() - b.double()
    return float(d.norm())


def _max_abs(a, b=None):
    d = a.double() if b is None else a.double() - b.double()
    return float(d.abs().max()) if d.numel() else 0.0


def _abs(a, b=None):
    return abs(a) if b is None else abs(a - b)


# each part of a step's outputs and its distance
PARTS = (("grads", _l2), ("terms", _abs), ("stats", _max_abs))


def distances(members, f32, dist=_l2, scale=None):
    """Per key of ``f32``: its size (``dist(f)``, or ``scale[key]``), the
    nominal member's distance to the f32 value and each other member's
    distance to the nominal one. The rule and the control are arithmetic
    on these."""
    c = members[0]
    out = {}
    for n, f in f32.items():
        size = dist(f) if scale is None else scale[n]
        out[n] = (size, dist(c[n], f),
                  [dist(m[n], c[n]) for m in members[1:]])
    return out


def rule_from(dists, got_dist):
    """The ensemble rule from :func:`distances` and the candidate's
    distance to the nominal member, per key. Returns ``(held, broken,
    ratios, spread)``."""
    held, broken, ratios, spread = [], [], {}, {}
    for n, (size, own, others) in dists.items():
        s = max([own] + others)
        spread[n] = s
        if not (size > 0 and s <= BF16_TAME * size):
            continue
        held.append(n)
        ratios[n] = got_dist[n] / (BF16_CROSS * s + BF16_SCALE * size)
        if not ratios[n] <= 1.0:  # NaN breaks too
            broken.append(n)
    return held, broken, ratios, spread


def bf16_valued(t):
    """Whether every entry of ``t`` is a bfloat16 value."""
    return bool(torch.equal(t, t.bfloat16().to(t.dtype)))


def faults_and_sharpness(got, nominal, dists, held, broken, names=BF16_HELD,
                         faults=FAULTS):
    """Each fault of ``faults`` and ``FINE_FAULT`` planted in the
    candidate's gradient of each held tensor of ``names``: its ratio, and
    for ``faults`` whether it broke the rule at its tensor alone
    (``missed`` lists those that did not); and each named held tensor's
    sharpness, the smallest factor ``1 + 2^-k`` (k <= ``SHARPNESS_K``)
    caught with every larger one, or None if 1.5 is missed. A fault changes
    one tensor, so only its ratio is computed anew."""
    reached, missed, sharp = {}, [], {}
    for name in (n for n in names if n in held):
        size, own, others = dists[name]
        bound = BF16_CROSS * max([own] + others) + BF16_SCALE * size
        g, c = got[name].double(), nominal[name].double()

        def ratio(factor):
            return float((factor * g - c).norm()) / bound

        rest = [n for n in broken if n != name]
        for fault in faults + (FINE_FAULT,):
            r = ratio(fault)
            reached[f"{name} x {fault}"] = r
            if fault in faults and (not r > 1.0 or rest):
                missed.append((name, fault))
        sharp[name] = None
        for k in range(1, SHARPNESS_K + 1):
            if not ratio(1 + 2.0 ** -k) > 1.0:
                break
            sharp[name] = 1 + 2.0 ** -k
    return reached, missed, sharp


def _quantiles(values):
    values = [v for v in values if v is not None]
    if not values:
        return None
    return {str(q): float(np.quantile(values, q)) for q in QUANTILES}


def _parts(ens, f32, before):
    """Per part of the outputs: the members' distances (:func:`distances`)
    and each control's ``(held, broken, ratios)`` by the ensemble rule."""
    members, nominal = ens["members"], ens["members"][0]
    parts = {}
    for part, dist in PARTS:
        ref = f32[part]
        scale = None
        if part == "stats":
            scale = {k: _max_abs(v, before[k]) for k, v in ref.items()}
        dists = distances([m[part] for m in members], ref, dist, scale)
        control = [rule_from(dists, {n: dist(m[part][n], nominal[part][n])
                                     for n in dists})[:3]
                   for m in ens.get("controls", [])]
        parts[part] = dict(dist=dist, dists=dists, control=control)
    return parts


def _control_broken(parts, labels):
    """``{control label: {part: keys broken}}`` of the controls that
    broke."""
    out = {}
    for i, label in enumerate(labels):
        broken = {part: p["control"][i][1] for part, p in parts.items()
                  if p["control"][i][1]}
        if broken:
            out[label] = broken
    return out


def grow(ens, f32, before, make_model, cfg, batch, bf16_grads=False,
         seeds=GROW_SEEDS):
    """While a control of ``ens`` (:func:`cpu_ensemble`'s, changed in place)
    breaks a held key, one more nudged step (a seed of ``seeds``, in order)
    joins the ensemble. No candidate takes part: the ensemble is settled
    by its controls before a candidate is judged by it. Returns the seeds
    added."""
    grown = []
    for seed in seeds:
        if not _control_broken(_parts(ens, f32, before),
                               ens.get("control_labels", [])):
            break
        t0 = time.perf_counter()
        ens["members"].append(step_outputs(make_model(), cfg,
                                           nudged(batch, seed), bf16_grads,
                                           update=False))
        ens["labels"].append(f"nudged {seed}")
        ens["seconds"].append(time.perf_counter() - t0)
        grown.append(seed)
    return grown


def judge(cand, ens, f32, before, names=BF16_HELD, floor=HELD_FLOOR):
    """The candidate step ``cand`` (:func:`step_outputs`' dict) against the
    ensemble ``ens`` (:func:`cpu_ensemble`'s), with the f32 step ``f32``
    for scale and ``before``, the running statistics before the step (a
    state dict or its ``running_`` entries). Returns the verdict: per part
    (gradients, loss terms, running statistics) the keys held, broken and
    the ratio quantiles; the worst three gradients with their spread; the
    control (each of ``ens["controls"]`` judged as the candidate is); the
    planted faults and the sharpness of each tensor they went into;
    ``not_bf16``; and ``ok``, false on a held key broken, a broken control,
    fewer gradient tensors held than the share ``floor`` of them (rounded
    up; ``held_floor``), a missed fault or a held
    gradient that is not a bf16 value where every member's is."""
    members, nominal = ens["members"], ens["members"][0]
    parts = _parts(ens, f32, before)
    for part, p in parts.items():
        got = {n: p["dist"](cand[part][n], nominal[part][n])
               for n in p["dists"]}
        held, broken, ratios, spread = rule_from(p["dists"], got)
        p.update(got=got, held=held, broken=broken, ratios=ratios,
                 spread=spread)
    g = parts["grads"]
    size = {n: d[0] for n, d in g["dists"].items()}
    held_floor = math.ceil(floor * len(size))
    named_held = [n for n in names if n in g["held"]]
    faults_at = named_held or sorted(g["held"], key=size.get,
                                     reverse=True)[:FAULT_FALLBACK]
    reached, missed, sharp = faults_and_sharpness(
        cand["grads"], nominal["grads"], g["dists"], g["held"], g["broken"],
        faults_at)
    not_bf16 = [n for n in g["held"] if not bf16_valued(cand["grads"][n])
                and all(bf16_valued(m["grads"][n]) for m in members)]
    control_broken = _control_broken(parts, ens.get("control_labels", []))

    def summary(p):
        return dict(held=len(p["held"]), of=len(p["dists"]),
                    broken=p["broken"],
                    ratio_max=max(p["ratios"].values(), default=None))

    def control_ratios(part):
        return [r for _, _, ratios in parts[part]["control"]
                for r in ratios.values()]

    verdict = dict(
        members=list(ens["labels"]),
        controls=list(ens.get("control_labels", [])),
        held=len(g["held"]), held_floor=held_floor, of=len(g["dists"]),
        broken=g["broken"], ratio_quantiles=_quantiles(g["ratios"].values()),
        worst={n: dict(ratio=g["ratios"][n], spread=g["spread"][n] / size[n],
                       cross=g["got"][n] / size[n])
               for n in sorted(g["ratios"], key=g["ratios"].get)[-3:]},
        named_held=named_held, faults_at=faults_at,
        terms=summary(parts["terms"]), stats=summary(parts["stats"]),
        control=dict(
            broken=control_broken,
            ratio_quantiles=_quantiles(control_ratios("grads")),
            terms_ratio_max=max(control_ratios("terms"), default=None),
            stats_ratio_max=max(control_ratios("stats"), default=None)),
        faults=reached, faults_missed=missed, sharpness=sharp,
        not_bf16=not_bf16)
    verdict["ok"] = not (g["broken"] or parts["terms"]["broken"]
                         or parts["stats"]["broken"] or control_broken
                         or len(g["held"]) < held_floor or not faults_at
                         or missed or not_bf16)
    return verdict
