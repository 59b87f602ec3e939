"""Optimizer and LR schedule on ``torch.optim``
(``fami_pose_tpu/optim/optimizer.py``).

Adam (default) or SGD; MultiStepLR with epoch milestones ``TRAIN.LR_STEP``
and factor ``TRAIN.LR_FACTOR``, turned into a *per-step* schedule by
``steps_per_epoch`` (the scheduler is stepped after every optimizer step);
and the optional second parameter group (``TRAIN.LR_SECOND_GROUP``, a list of
name prefixes, with its own base LR ``TRAIN.LR_SECOND_GROUP_VALUE`` and the
same milestones).

The update with 0-based index n runs at ``lr * factor ** #{m : m *
steps_per_epoch <= n}``, as ``optax.piecewise_constant_schedule`` gives the
JAX package: the boundary step itself already has the lower rate.
Adam's ``eps = 1e-8`` sits outside the root in both packages.
"""

import torch


def build_lr_lambda(cfg, steps_per_epoch=1):
    """Step index -> multiplier of the base LR."""
    factor = float(cfg.TRAIN.LR_FACTOR)
    bounds = [int(m) * int(steps_per_epoch) for m in cfg.TRAIN.LR_STEP]

    def lr_lambda(step):
        return factor ** sum(1 for b in bounds if b <= step)

    return lr_lambda


def top_level_name(param_name):
    """The top-level scope a parameter has in the JAX package's tree: the
    first component of its name, except that the shared heatmap head
    ``hrnet.final_layer`` is scoped there as ``final_layer``, outside
    ``hrnet``."""
    parts = param_name.split(".")
    if parts[:2] == ["hrnet", "final_layer"]:
        return "final_layer"
    return parts[0]


def _make(cfg, groups):
    name = str(cfg.TRAIN.OPTIMIZER).lower()
    if name == "adam":
        return torch.optim.Adam(groups, lr=float(cfg.TRAIN.LR))
    if name == "sgd":
        return torch.optim.SGD(
            groups, lr=float(cfg.TRAIN.LR),
            momentum=float(cfg.TRAIN.MOMENTUM),
            nesterov=bool(cfg.TRAIN.NESTEROV),
        )
    raise KeyError(f"Unknown optimizer {cfg.TRAIN.OPTIMIZER!r}")


def build_optimizer(cfg, model, steps_per_epoch=1):
    """Returns ``(optimizer, scheduler)`` for ``model``'s parameters. Call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    second = [p for p in cfg.TRAIN.LR_SECOND_GROUP if p]
    main_params, second_params = [], []
    for name, p in model.named_parameters():
        top = top_level_name(name)
        if any(top.startswith(prefix) for prefix in second):
            second_params.append(p)
        else:
            main_params.append(p)
    groups = [{"params": main_params, "lr": float(cfg.TRAIN.LR)}]
    if second_params:
        groups.append({"params": second_params,
                       "lr": float(cfg.TRAIN.LR_SECOND_GROUP_VALUE)})
    optimizer = _make(cfg, groups)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, build_lr_lambda(cfg, steps_per_epoch)
    )
    return optimizer, scheduler
