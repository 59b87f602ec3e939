"""Core-function registry: named builders of the train and eval steps
(``fami_pose_tpu/engine/core_functions.py``).

The reference dispatches its training and eval loops through
``CORE_FUNCTION_REGISTRY`` keyed on ``cfg.CORE_FUNCTION``; here a core
function bundles the step builders with the loss configuration, and
``Trainer`` / ``Evaluator`` take their steps from it.

``TPU.DONATE_TRAIN_STATE`` has nothing to do here: the port's train step
updates the model and the optimizer in place, so no second copy of the
state exists to donate.
"""

from fami_pose_torch.utils.registry import CORE_FUNCTION_REGISTRY

from .steps import make_eval_step, make_train_step


class BaseCoreFunction:
    def __init__(self, cfg):
        self.cfg = cfg

    def build_train_step(self, model, mesh=None):
        raise NotImplementedError

    def build_eval_step(self, model, flip_pairs=None, flip_test=False,
                        mesh=None):
        raise NotImplementedError


@CORE_FUNCTION_REGISTRY.register(name="AlignmentMIFunction_Term6_V1")
@CORE_FUNCTION_REGISTRY.register(name="FAMIPoseFunction")
class AlignmentMIFunction(BaseCoreFunction):
    """Heatmap MSE + per-supporting-frame MSE + 6-term MI training;
    flip-test eval."""

    def build_train_step(self, model, mesh=None):
        """The train step of ``model`` over ``mesh`` (``parallel/mesh.py``;
        None: one device); ``TPU.BF16_GRADS`` takes effect when the model
        computes in bfloat16."""
        return make_train_step(
            mse_weight=float(self.cfg.LOSS.HEATMAP_MSE.WEIGHT),
            mi_alpha=float(getattr(self.cfg.LOSS, "MI_ALPHA", 0.5)),
            mi_beta=float(getattr(self.cfg.LOSS, "MI_BETA", 0.1)),
            bf16_grads=bool(getattr(self.cfg.TPU, "BF16_GRADS", False)),
            mesh=mesh,
        )

    def build_eval_step(self, model, flip_pairs=None, flip_test=False,
                        mesh=None):
        return make_eval_step(model, flip_test=flip_test,
                              flip_pairs=flip_pairs, mesh=mesh)


def core_function_class(cfg):
    """The registered class of ``cfg.CORE_FUNCTION`` (empty: the FAMI-Pose
    one); a name not registered raises ``KeyError``."""
    name = cfg.CORE_FUNCTION or "FAMIPoseFunction"
    if name not in CORE_FUNCTION_REGISTRY:
        raise KeyError(
            f"Unknown core function {name!r}; available: "
            f"{sorted(CORE_FUNCTION_REGISTRY.keys())}"
        )
    return CORE_FUNCTION_REGISTRY.get(name)


def build_core_function(cfg):
    """The core function of ``cfg.CORE_FUNCTION`` (:func:`core_function_class`)."""
    return core_function_class(cfg)(cfg)
