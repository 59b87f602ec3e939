from .heatmap import build_loss, fami_total_loss, joint_mse_loss  # noqa: F401
from .optional import (  # noqa: F401
    integral_l1_loss, soft_argmax, structure_cosine_loss,
)
