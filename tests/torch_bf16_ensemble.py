"""Helpers of the tests that judge a bf16 train step by an ensemble of
roundings (``fami_pose_torch/tools/bf16_judge.py``): the JAX step's
outputs in the judge's form, JAX's batch nudged as the judge nudges the
port's, the member whose DCN rounds as the card's kernels do, and the checks both
test files make."""

import contextlib

import jax
import numpy as np
import torch

from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.tools import bf16_judge as J


def jax_outputs(new, metrics):
    """A JAX Adam step's outputs (its gradients kept beside Adam's state,
    ``opt_state[1]``) as :func:`bf16_judge.step_outputs` gives the port's:
    loss terms, gradients and running statistics under the port's names."""
    grads = state_dict_from_flax({"params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), new.opt_state[1])})
    state = state_dict_from_flax({
        "params": jax.tree.map(np.asarray, new.params),
        "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    return dict(
        terms={k: float(v) for k, v in metrics.items()
               if k.startswith("loss")},
        grads={k: torch.as_tensor(v) for k, v in grads.items()},
        stats={k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
               if "running_" in k})


def jax_nudged(batch, seed, keys=("kf", "sup")):
    """JAX's batch (NHWC) with each frame element scaled by ``1 + s
    bf16_judge.NUDGE``, s = +-1 drawn from ``np.random.RandomState(seed)``
    as :func:`bf16_judge.nudged` draws the port's."""
    rs = np.random.RandomState(seed)
    out = dict(batch)
    for k in keys:
        a = np.asarray(batch[k], np.float32)
        s = rs.randint(0, 2, size=a.shape) * 2 - 1
        out[k] = a * (1 + s * J.NUDGE).astype(np.float32)
    return out


def running_stats(state_dict):
    return {k: v for k, v in state_dict.items() if "running_" in k}


def port_outputs(step):
    """``test_torch_train_levers._port_bf16_step``'s dict in the judge's
    form."""
    return dict(terms={k: v for k, v in step["aux"].items()
                       if k.startswith("loss")},
                grads=step["grads"], stats=running_stats(step["state"]))


def jax_ensemble(run, batch):
    """JAX's ensemble: ``run(batch)`` (one compiled step) on the batch and
    on each ``bf16_judge.NUDGE_SEEDS`` nudged copy."""
    return dict(
        members=[run(batch)] + [run(jax_nudged(batch, s))
                                for s in J.NUDGE_SEEDS],
        labels=["nominal"] + [f"nudged {s}" for s in J.NUDGE_SEEDS])


def with_fault(cand, name, factor):
    """``cand`` with the gradient of ``name`` scaled by ``factor``."""
    return dict(cand, grads=dict(cand["grads"],
                                 **{name: factor * cand["grads"][name]}))


def with_f32(cand, f32, name):
    """``cand`` with the gradient of ``name`` taken from the f32 step."""
    return dict(cand, grads=dict(cand["grads"], **{name: f32["grads"][name]}))


def strays(jax_step, port_ens, f32, broken):
    """Each tensor of ``broken`` (JAX's step broken by the port's ensemble):
    JAX's own gap to the f32 step over the port ensemble's spread."""
    dists = J.distances([m["grads"] for m in port_ens["members"]],
                        f32["grads"])
    out = {}
    for n in broken:
        _, own, others = dists[n]
        out[n] = J._l2(jax_step["grads"][n], f32["grads"][n]) / max(
            [own] + others)
    return out


def _columns(forward, x, offset, mask, weight, padding, dilation, groups,
             max_offset):
    """The plain DCN's sampled column, rounded once to ``x``'s dtype:
    (N, K*C, Ho, Wo) in the ``[k][c]`` row order of the plain forward
    ``forward`` (``ops/deform_conv.py::deform_conv2d``), which forms it
    with an identity weight: each output is one product with 1.0, exact in
    float32, then cast."""
    c, (kh, kw) = x.shape[1], weight.shape[2:]
    rows = kh * kw * c
    eye = torch.eye(rows, dtype=x.dtype).reshape(rows, kh, kw, c)
    return forward(x, offset, mask, eye.permute(0, 3, 1, 2), None, stride=1,
                   padding=padding, dilation=dilation, offset_groups=groups,
                   max_offset=max_offset)


@contextlib.contextmanager
def card_rounding():
    """Within the block the port's plain DCN (the CPU route of
    ``ops/deform_conv.py``) rounds the sampled column to bf16 once where
    ``x`` is bf16, as the card's kernels do: the forward sums the bf16
    column's products with the bf16 weight in float32 and rounds the sum
    once (``csrc/dcn_fwd.cu``), and the backward forms dW from the bf16
    column (``csrc/dcn_bwd.cu``; dx, the offsets' and the mask's
    gradients as the plain version's). Other dtypes run the plain version
    unchanged."""
    from fami_pose_torch.ops import deform_conv as dc

    forward, backward = dc.deform_conv2d, dc.deform_conv2d_backward

    def conf(kw):
        return (kw.get("padding", 0), kw.get("dilation", 1),
                kw.get("offset_groups"), kw.get("max_offset"))

    def rounded_forward(x, offset, mask, weight, bias=None, **kw):
        if x.dtype != torch.bfloat16 or kw.get("stride", 1) != 1:
            return forward(x, offset, mask, weight, bias, **kw)
        col = _columns(forward, x, offset, mask, weight,
                       *conf(kw)).float()
        n, rows, ho, wo = col.shape
        w_flat = weight.float().permute(0, 2, 3, 1).reshape(-1, rows)
        out = torch.matmul(w_flat, col.reshape(n, rows, ho * wo))
        out = out.reshape(n, -1, ho, wo).to(x.dtype)
        if bias is not None:
            out = out + bias.to(out.dtype).view(1, -1, 1, 1)
        return out

    def rounded_backward(x, offset, mask, weight, gout, **kw):
        dx, doff, dmask, dweight = backward(x, offset, mask, weight, gout,
                                            **kw)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            col = _columns(forward, x, offset, mask, weight,
                           *conf(kw)).float()
            n, rows, ho, wo = col.shape
            c_out, c, kh, kw_ = weight.shape
            dw = torch.einsum("nop,nrp->or",
                              gout.float().reshape(n, c_out, ho * wo),
                              col.reshape(n, rows, ho * wo))
            dweight = dw.reshape(c_out, kh, kw_, c).permute(0, 3, 1, 2).to(
                weight.dtype)
        return dx, doff, dmask, dweight

    dc.deform_conv2d = rounded_forward
    dc.deform_conv2d_backward = rounded_backward
    try:
        yield
    finally:
        dc.deform_conv2d, dc.deform_conv2d_backward = forward, backward


def card_rounded_step(make_model, cfg, batch, bf16_grads=False):
    """The port's bf16 step on the CPU (:func:`bf16_judge.step_outputs`,
    no update) under :func:`card_rounding`: one more rounding, which the
    ensemble must hold as it holds the card."""
    with card_rounding():
        return J.step_outputs(make_model(), cfg, batch, bf16_grads,
                              update=False)
