from .heatmap import build_loss, fami_total_loss, joint_mse_loss  # noqa: F401
