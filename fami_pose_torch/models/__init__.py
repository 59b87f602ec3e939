"""Models: layers, HRNet, FAMIPose, and the weight bridge."""


def get_model_hyperparameter(cfg):
    """Experiment-identity string used in the output directory layout
    (``fami_pose_tpu.models.get_model_hyperparameter`` for the FAMI-Pose
    model names; empty for any other model)."""
    if str(cfg.MODEL.NAME) not in ("FAMIPose", "Alignment_V15"):
        return ""
    bbox_factor = cfg.DATASET.BBOX_ENLARGE_FACTOR
    rot_factor = cfg.TRAIN.ROT_FACTOR
    sf = cfg.TRAIN.SCALE_FACTOR
    if not isinstance(sf, (list, tuple)):
        sf = [sf, sf]
    param = f"bbox_{bbox_factor}_rot_{rot_factor}_scale_{1 - sf[0]}-{1 + sf[1]}"
    if cfg.LOSS.HEATMAP_MSE.USE:
        param += f"_MseLoss_{cfg.LOSS.HEATMAP_MSE.WEIGHT}"
    return param
