"""Train and eval steps (``fami_pose_tpu/engine/steps.py``).

The train step does forward, loss, backward, optimizer and scheduler step
and returns its metrics as device tensors: nothing in it waits for the
device, so the caller fetches them only when it prints. The eval step is
the forward, plus flip-test averaging behind ``flip_test``.

Over a mesh of more than one rank (``parallel/mesh.py``) each rank runs
the train step on its data index's slice of the global batch: BatchNorm
normalizes with the global batch's statistics, the gradients are averaged
across ranks before the optimizer, and the metrics are the global batch's.
The ranks of one data index (a ``model`` axis) replicate one another and
end each step with the same averaged gradient.
The eval step runs the forward on the rank's slice; the evaluator gathers
the decoded predictions."""

import contextlib

import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS
from fami_pose_torch.losses import fami_total_loss
from fami_pose_torch.models.layers import sync_batch_norm
from fami_pose_torch.ops.pose import flip_back
from fami_pose_torch.parallel.mesh import all_reduce_mean_, is_distributed


def pck_counts(pred, target, thr=0.5):
    """Per joint, the (sample, joint) pairs that are valid and those that
    are correct under :func:`heatmap_pck_accuracy`'s rule: two (J,) int64
    tensors, which sum over the slices of a batch."""
    b, j, h, w = pred.shape

    def argmax_xy(hm):
        flat = hm.to(torch.float32).reshape(b, j, h * w)
        maxv, idx = flat.max(dim=2)  # the first maximum, as jnp.argmax
        vis = (maxv > 0).to(torch.float32)
        return (idx % w).to(torch.float32) * vis, (idx // w).to(torch.float32) * vis

    px, py = argmax_xy(pred)
    tx, ty = argmax_xy(target)
    d = torch.sqrt(((px - tx) / (h / 10.0)) ** 2 + ((py - ty) / (w / 10.0)) ** 2)
    valid = (tx > 1) & (ty > 1)
    correct = (d < thr) & valid
    return correct.sum(dim=0), valid.sum(dim=0)


def pck_from_counts(correct_j, cnt_j):
    """``(avg_acc, counted_joints)`` from :func:`pck_counts`' sums."""
    acc_j = correct_j / cnt_j.clamp(min=1)
    has = cnt_j > 0
    n_counted = has.sum()
    acc = torch.where(
        n_counted > 0,
        (acc_j * has).sum() / n_counted.clamp(min=1),
        torch.zeros((), device=correct_j.device),
    )
    return acc, n_counted


def heatmap_pck_accuracy(pred, target, thr=0.5):
    """Train-time PCK from the heatmaps' argmax, with the reference's
    semantics: a (sample, joint) pair is valid iff BOTH argmax coordinates
    of the target exceed 1 (an all-zero target decodes to (0, 0) and fails);
    x distances are normalized by h/10 and y distances by w/10 (the
    reference's axis swap); per-joint accuracies are taken over the valid
    pairs and averaged, unweighted, over the joints that have one.

    pred/target: (B, J, H, W). Returns ``(avg_acc, counted_joints)`` as
    tensors on their device.
    """
    return pck_from_counts(*pck_counts(pred, target, thr))


def cast_copies(params, dtype):
    """Leaf copies of ``params`` in ``dtype``, each with its parameter's
    ``requires_grad``: views of one concatenation cast at once."""
    flat = torch.cat([p.detach().reshape(-1) for p in params]).to(dtype)
    return [v.view(p.shape).requires_grad_(p.requires_grad)
            for p, v in zip(params, flat.split([p.numel() for p in params]))]


def set_grads(params, grads):
    """Each parameter's ``.grad`` set to its gradient in ``grads`` cast to
    its dtype (None for None): one concatenation cast at once, of which the
    ``.grad`` tensors are views."""
    have = [(p, g) for p, g in zip(params, grads) if g is not None]
    if have:
        flat = torch.cat([g.reshape(-1) for _, g in have]).to(
            have[0][0].dtype)
        for (p, _), g in zip(have, flat.split([p.numel() for p, _ in have])):
            p.grad = g.view(p.shape).to(p.dtype)
    for p, g in zip(params, grads):
        if g is None:
            p.grad = None


@contextlib.contextmanager
def params_cast(model, dtype):
    """Swap each floating parameter of ``model`` for a leaf copy of it in
    ``dtype`` (:func:`cast_copies`) for the duration of the block, and
    yield ``{id(parameter): copy}``: a forward and backward inside the block
    differentiate with respect to the copies, and a rematerialized module's
    second pass, run during the backward, sees them too. On leaving the
    block the parameters are put back, with their dtype, values and
    optimizer state untouched, and the copies' gradients become theirs
    (:func:`set_grads`).

    A copy is put in its module's instance ``__dict__``, where attribute
    lookup finds it before ``nn.Module.__getattr__`` would look in
    ``_parameters`` (from which the parameter is taken out meanwhile): a
    dictionary operation a parameter, not ``nn.Module.__setattr__``'s
    checks."""
    params = [p for p in model.parameters() if p.is_floating_point()]
    copies = dict(zip(map(id, params), cast_copies(params, dtype)))
    swapped = []
    try:
        for module in model.modules():
            for name, p in list(module._parameters.items()):
                if p is None or id(p) not in copies:
                    continue
                del module._parameters[name]
                module.__dict__[name] = copies[id(p)]
                swapped.append((module, name, p))
        yield copies
    finally:
        for module, name, p in reversed(swapped):
            del module.__dict__[name]
            module._parameters[name] = p
    set_grads(params, [copies[id(p)].grad for p in params])


def average_gradients(params):
    """Average the gradients of ``params`` across the ranks in one flat
    bucket (one all-reduce), in place; parameters without a gradient (the
    same on every rank) are left out."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads]))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_train_step(mse_weight=1.0, mi_alpha=0.5, mi_beta=0.1,
                    bf16_grads=False, mesh=None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``: ``state`` is a
    ``TrainState`` (updated in place) whose model is in training mode
    (``model.train()``), ``batch`` a dict with ``kf``
    (B, 3, H, W), ``sup`` (B, 3N, H, W), ``target`` (B, J, h, w) and
    ``target_weight`` (B, J) on the model's device. ``metrics`` holds the
    loss terms and the PCK accuracies as detached device tensors.

    ``bf16_grads`` (``TPU.BF16_GRADS``), when the model computes in
    bfloat16: the forward and backward differentiate with respect to a
    bfloat16 copy of every floating parameter (:func:`params_cast`), so the
    gradients are formed and summed in bfloat16, as the JAX step
    differentiates with respect to a bfloat16 cast of its parameters. Each
    gradient is then cast to its float32 master parameter's dtype, and Adam
    updates the masters in float32. The convs and the DCN already compute
    with their weights cast to bfloat16, so their forward is unchanged;
    BatchNorm and any float32 use see the bfloat16-rounded values, as in
    flax.

    ``mesh`` (``parallel.mesh.build_mesh``) of more than one rank:
    ``batch`` is this rank's data index's slice of the global batch (equal
    slices; the ranks of one data index hold the same one). The model's
    BatchNorms take the global batch's statistics
    (``models.layers.sync_batch_norm``, applied at the first call); after
    the backward the gradients are averaged across ranks in one flat
    bucket (:func:`average_gradients`), before the optimizer. Each rank's
    loss is the mean over its equal slice, so that average is the gradient
    of the global batch's loss. The loss terms are averaged across ranks
    and the PCK accuracies computed from the global batch's counts, in one
    more all-reduce.

    The step runs with cuDNN's deterministic algorithms
    (``torch.backends.cudnn.deterministic``, restored afterwards): with
    the DCN backward's fixed-order sums, two steps from one state on one
    card give the same bits."""
    sync = is_distributed(mesh)
    synced = []

    def loss_and_metrics(model, batch):
        final, sup_hms, kf_bb, mi = model(batch["kf"], batch["sup"], train=True)
        total, aux = fami_total_loss(
            final, sup_hms, mi, batch["target"], batch["target_weight"],
            mse_weight=mse_weight, mi_alpha=mi_alpha, mi_beta=mi_beta,
        )
        return total, (aux, final, sup_hms, kf_bb)

    def step(state, batch):
        # cuDNN's deterministic algorithms for the step: its float32 weight
        # gradients otherwise vary from run to run; in bfloat16 the main
        # path's step took the same device time with them (PERF.md).
        # The one attribute, not ``torch.backends.cudnn.flags``, which would
        # reset the others.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return _step(state, batch)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _step(state, batch):
        model = state.model
        if sync and not any(m is model for m in synced):
            sync_batch_norm(model, mesh)
            synced.append(model)
        state.optimizer.zero_grad(set_to_none=True)
        low = bf16_grads and getattr(model, "compute_dtype",
                                     torch.float32) == torch.bfloat16
        if low:
            with params_cast(model, torch.bfloat16):
                total, (aux, final, sup_hms, kf_bb) = loss_and_metrics(
                    model, batch)
                total.backward()
        else:
            total, (aux, final, sup_hms, kf_bb) = loss_and_metrics(
                model, batch)
            total.backward()
        if sync:
            # under bf16_grads each rank's gradient was formed in bfloat16
            # and widened to float32 on leaving params_cast: the sum across
            # ranks is taken and rounded in float32
            average_gradients(list(model.parameters()))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            heads = {"acc": final, "acc_kf_backbone": kf_bb}
            heads.update((f"acc_sup{i + 1}", hm)
                         for i, hm in enumerate(sup_hms))
            if not sync:
                metrics = {k: v.detach() for k, v in aux.items()}
                for k, hm in heads.items():
                    metrics[k], _ = heatmap_pck_accuracy(hm, batch["target"])
                return state, metrics
            # one all-reduce: the loss terms averaged, the PCK counts
            # scaled by the data axis so that their average over the ranks
            # (each data index's counted model times) is their sum over the
            # slices (integers, exact in float32)
            counts = [torch.stack(pck_counts(hm, batch["target"]))
                      for hm in heads.values()]
            flat = all_reduce_mean_(torch.cat(
                [torch.stack([v.detach().to(torch.float32)
                              for v in aux.values()])]
                + [c.reshape(-1).to(torch.float32) * mesh.data
                   for c in counts]))
            metrics = dict(zip(aux, flat[:len(aux)]))
            for k, c in zip(heads, flat[len(aux):].split(
                    [c.numel() for c in counts])):
                metrics[k], _ = pck_from_counts(*c.view(2, -1))
        return state, metrics

    return step


def make_eval_step(model, flip_test=False, flip_pairs=None, mesh=None):
    """Returns ``eval_fn(kf, sup) -> (final_hm, kf_bb_hm)``: NCHW inputs,
    float32 (B, J, h, w) heatmaps. With ``flip_test`` a second forward runs
    on the mirrored inputs, is flipped back (left/right joints swapped) and
    averaged into ``final_hm``, as the JAX eval step does.

    Over a ``mesh`` the inputs are this rank's slice of the global batch
    and the heatmaps are the slice's: an eval-mode forward is per sample,
    so the step issues no collective, and the evaluator gathers the
    decoded predictions (``engine/evaluator.py``)."""
    del mesh  # the forward is the same on every slice
    pairs = flip_pairs if flip_pairs is not None else COCO_FLIP_PAIRS

    @torch.inference_mode()
    def step(kf, sup):
        final, kf_bb = model(kf, sup)
        if flip_test:
            f_final, _ = model(torch.flip(kf, dims=(3,)),
                               torch.flip(sup, dims=(3,)))
            final = (final + flip_back(f_final, pairs)) * 0.5
        return final.to(torch.float32), kf_bb.to(torch.float32)

    return step
