"""Model builder: ``MODEL_REGISTRY`` dispatch on ``cfg.MODEL.NAME``
(``fami_pose_tpu/models/build.py``).

A port model is an ``nn.Module`` whose ``from_config(cfg, phase)`` builds it
with random parameters; the trainer and the evaluator initialise or load
them (``models/bridge.py``, ``engine/checkpoints.py``)."""

from fami_pose_torch.utils.registry import MODEL_REGISTRY

from . import fami_pose  # noqa: F401  (registers FAMIPose, Alignment_V15)


def model_class(cfg):
    """The registered model class of ``cfg.MODEL.NAME``; a name not
    registered raises ``KeyError``."""
    name = cfg.MODEL.NAME
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY.keys())}"
        )
    return MODEL_REGISTRY.get(name)


def build_model(cfg, phase="train"):
    """The model of ``cfg.MODEL.NAME`` (:func:`model_class`), built for
    ``phase``."""
    return model_class(cfg).from_config(cfg, phase=phase)
