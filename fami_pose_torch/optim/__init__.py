from .optimizer import build_lr_lambda, build_optimizer  # noqa: F401
