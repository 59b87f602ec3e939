"""Default configuration tree (a copy of ``fami_pose_tpu/config/defaults.py``).

The key surface is the JAX package's, so every YAML under ``configs/`` merges
unchanged. Of the ``TPU`` sub-tree the port reads only the knobs that change
what the model computes: ``COMPUTE_DTYPE``, ``DCN_MAX_OFFSET`` (<= 0 or null
selects the exact, unclamped DCN), ``DCN_OFFSET_GROUPS``, ``WARP_IMPL`` (where a
bf16 warp rounds, as the JAX warp of that name, and the warp clamp: 32 for
``"slice"``, else ``WARP_MAX_SHIFT``) and
``WARP_MAX_SHIFT``. The other ``TPU`` keys (mesh, Pallas, remat, int8, device
crop, ...) are accepted and ignored.
"""

from .node import CfgNode


def _node(d: dict, new_allowed: bool = False) -> CfgNode:
    return CfgNode(d, new_allowed=new_allowed)


def get_default_cfg() -> CfgNode:
    c = CfgNode(new_allowed=False)

    # -- top level -------------------------------------------------------------
    c.ROOT_DIR = ""
    c.EXPERIMENT_NAME = ""
    c.OUTPUT_DIR = ""
    c.SAVE_HEATMAPS = False
    c.LOAD_HEATMAPS = False
    c.SAVE_PREDS = False
    c.PREDS_SFX = ""
    c.LOAD_PREDS = False
    c.SAVE_OFFSETS = False
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.MODEL_DIR = ""
    c.GPUS = (0,)  # retained for config compatibility; ignored on TPU
    c.WORKERS = 8
    c.PRINT_FREQ = 20
    c.PIN_MEMORY = True
    c.RANK = 0
    c.SEED = 19970808
    c.DISTANCE = 2
    c.NUMBER_SUP = 2
    c.CORE_FUNCTION = ""

    c.PATH_ADD_DESCRIPTIONS = _node(
        {"TRAIN": True, "MODEL": True, "DATASET": True, "LOSS": True}
    )

    # retained for YAML compatibility with the reference; no-ops on TPU
    c.CUDNN = _node({"BENCHMARK": True, "DETERMINISTIC": False, "ENABLED": True})

    # -- TPU / XLA execution (new; no analog in the reference) -----------------
    c.TPU = _node(
        {
            "MESH_AXES": ["data"],      # mesh axis names
            "MESH_SHAPE": [-1],          # -1 => all available devices
            "COMPUTE_DTYPE": "bfloat16", # backbone/head compute dtype
            "PARAM_DTYPE": "float32",
            "PREFETCH_DEPTH": 2,
            "DONATE_TRAIN_STATE": True,
            # write per-epoch checkpoints on a background thread so the
            # chips never wait on disk; every pending write is joined at
            # trainer exit (engine/checkpoints.wait_for_pending_saves), so
            # the final epoch's checkpoint cannot be lost
            "ASYNC_CHECKPOINT": False,
            "USE_PALLAS_DCN": True,
            # offset/mask convs emit the Pallas staging layout directly
            # (kernel-major NCHW), skipping the DCN prep transposes
            "DCN_AUX_CHANNEL_FIRST": True,
            # bounded-offset window for the gather-free deformable conv;
            # None/0 selects the exact (slow) gather path
            "DCN_MAX_OFFSET": 6,
            # calibrate the window to the CHECKPOINT at evaluator setup:
            # measure the offset-conv outputs on the first
            # INT8_CALIB_BATCHES eval batches and pick the smallest D whose
            # exceeded fraction is <= DCN_AUTO_WINDOW_EPS. A window below
            # the trained distribution has a real measured AP cost (−0.65
            # mean at D=1/2 on the articulated checkpoint) while clamping a
            # <=0.1% outlier tail measured AP-exact (D=4 there) —
            # docs/DCN_OFFSET_BOUND.md. EPS=0 selects a strict cover
            # (exact by construction); distributions hotter than
            # DCN_AUTO_WINDOW_MAX fall back to the exact gather.
            "DCN_AUTO_WINDOW": False,
            "DCN_AUTO_WINDOW_EPS": 1e-3,
            "DCN_AUTO_WINDOW_MAX": 8,
            "DCN_OFFSET_GROUPS": 12,
            "PROFILE_DIR": "",
            "PROFILE_STEPS": 10,
            "REMAT_BACKBONE": False,
            # accumulate backward cotangents in bf16 (f32 Adam master stays);
            # only active when COMPUTE_DTYPE is bfloat16 (engine/steps.py).
            # Measured on-chip at W48 batch 8: 519.8 ms vs 513.8 ms f32 —
            # no benefit (the convert/reduce bucket is NOT gradient
            # accumulation; see docs/PERFORMANCE.md round 3), so off by
            # default; kept as an option for larger-batch regimes.
            "BF16_GRADS": False,
            # move the person-box crop-warp (reference HOT LOOP #1:
            # per-sample cv2.warpAffine, PoseTrack_Alignment.py:416-423)
            # on-device: the dataset emits raw frame windows and the jitted
            # batch prep runs ops.warp.crop_and_warp. Costs a larger H2D
            # transfer (the canvas window) in exchange for freeing host CPU.
            "DEVICE_CROP": False,
            # (h, w) of the person-centered raw window shipped to device;
            # boxes whose source region exceeds it get zero-padded corners
            "DEVICE_CROP_CANVAS": [768, 768],
            # int8 serving mode: per-channel-weight / per-tensor-activation
            # PTQ of the backbone convs for eval phases (models/quant.py).
            # NON-PARITY fast path; bf16 stays the default. Calibration runs
            # on the first INT8_CALIB_BATCHES eval batches.
            "INT8_EVAL": False,
            "INT8_CALIB_BATCHES": 2,
            # headroom factor on calibrated activation absmax
            "INT8_CALIB_MARGIN": 1.0,
            # global-alignment translation-warp implementation:
            #   "slice"  - vmapped dynamic_slice (the parity reference)
            #   "matmul" - MXU selection-matrix form, ~5.6x on-chip with
            #              identical semantics (ops.warp.warp_translate_matmul)
            #   "pallas" - fused kernel (ops/pallas/warp.py); matches matmul
            #              op-level but its custom-call layout constraint is
            #              slower in-graph
            "WARP_IMPL": "matmul",
            # clamp for translations under matmul/pallas ("slice" clamps at
            # 32; pallas lane budget: W + 2*(shift+1) <= 128 at W=72)
            "WARP_MAX_SHIFT": 26,
        }
    )

    # -- model ------------------------------------------------------------------
    c.MODEL = _node(
        {
            "NAME": "pose_hrnet",
            "INIT_WEIGHTS": True,
            "FREEZE_WEIGHTS": False,
            "FREEZE_PredNet_WEIGHTS": True,
            "PRETRAINED": "",
            "BACKBONE_PRETRAINED": "",
            "NUM_JOINTS": 17,
            "TARGET_TYPE": "gaussian",
            "IMAGE_SIZE": [256, 256],   # width, height
            "HEATMAP_SIZE": [64, 64],   # width, height
            "SIGMA": 2,
            "CYCLE_CONSISTENCY_FINETUNE": False,
            "DEFORAM_CONV_VERSION": 1,
            "USE_RECTIFIER": True,
            "USE_MARGIN": True,
            "USE_GROUP": True,
            "HIGH_RESOLUTION": False,
            "FREEZE_HRNET_WEIGHTS": False,
            "MPII_PRETRAINED": False,
            "USE_WARPING_TRAIN": True,
            "USE_WARPING_TEST": True,
            "WARPING_REVERSE": False,
            "USE_GT_INPUT_TEST": False,
            "USE_GT_INPUT_TRAIN": False,
            "ITER": 30000,
            "EVALUATE": True,
            "DILATION_EXP": 0,
            "VISUALIZE_OFFSETS": False,
            "USE_PIXEL_LEVEL_OFFSET": True,
            "USE_PRF": True,
            "PRF_BASICBLOCK_NUM": 10,
            "PRF_INNER_CH": 12,
            "USE_PTM": True,
            "PTM_BASICBLOCK_NUM": 10,
            "PTM_INNER_CH": 12,
            "PRF_PTM_COMBINE_INNER_CH": 10,
            "PRF_PTM_COMBINE_BASICBLOCK_NUM": 10,
            "USE_PCN": True,
            "TEMPORAL_INTERPOLATION": False,
            "BACKBONE_PRECOMPUTE": False,
            "WITH_DCPOSE": False,
            "WARP_LEVEL": "Image",
            "LOCAL_WARP_LEVEL": "Image",
            "GLOBAL_WARP_LEVEL": "Image",
        }
    )
    c.MODEL.EXTRA = CfgNode(new_allowed=True)
    c.MODEL.DEFORMABLE_CONV = CfgNode(new_allowed=True)
    c.MODEL.GLOBAL_WARP = _node(
        {
            "LEVEL": "Patch",
            "PATCH_WINDOW_SIZE": (4, 3),
            "PATCH_WINDOW_STRIDE": (4, 3),
            "FEATMAP": {
                "LEVEL": "Image",
                "PATCH_WINDOW_SIZE": (96, 72),
                "PATCH_WINDOW_STRIDE": (96, 72),
            },
            "HEATMAP": {
                "LEVEL": "Image",
                "PATCH_WINDOW_SIZE": (96, 72),
                "PATCH_WINDOW_STRIDE": (96, 72),
            },
        }
    )
    c.MODEL.LOCAL_WARP = _node(
        {
            "LEVEL": "Patch",
            "PATCH_WINDOW_SIZE": (12, 9),
            "PATCH_WINDOW_STRIDE": (12, 9),
            "FEATMAP": {
                "LEVEL": "Patch",
                "PATCH_WINDOW_SIZE": (12, 9),
                "PATCH_WINDOW_STRIDE": (12, 9),
            },
            "HEATMAP": {
                "LEVEL": "Image",
                "PATCH_WINDOW_SIZE": (96, 72),
                "PATCH_WINDOW_STRIDE": (96, 72),
            },
        }
    )

    # -- loss ----------------------------------------------------------------------
    def _use_weight(use: bool, weight: float, **extra) -> dict:
        d = {"USE": use, "WEIGHT": weight}
        d.update(extra)
        return d

    c.LOSS = _node(
        {
            "AVG_LOSS": False,
            "GRAD_MAX_NORM": 0.02,
            "MI_SUMMATION_WEIGHT": 1.0,
            "COMPLEMENTARY": _use_weight(False, 0.1),
            "VANISHING": _use_weight(False, 1.0),
            "IMAGE_RECON": _use_weight(False, 0.5),
            "CONSISTENCY": _use_weight(True, 1.0),
            "FM_GLOBAL_LOCAL": _use_weight(False, 0.5),
            "FM_GLOBAL_KF": _use_weight(False, 0.5),
            "HEATMAP_MSE": _use_weight(True, 1.0, DIVIDED_NUM_JOINTS=True),
            "FEATMAP_MSE": _use_weight(False, 0.5),
            "LOCAL_HM": _use_weight(True, 1.0),
            "GLOBAL_HM": _use_weight(True, 0.5),
            "LOCAL_FEAT": _use_weight(False, 0.8),
            "GLOBAL_FEAT": _use_weight(False, 0.2),
            "GLOBAL_ALIGNMENT": _use_weight(False, 0.01),
            "LOCAL_ALIGNMENT": _use_weight(False, 0.1),
            "OFFSET_WARM_UP_EPOCH": 0,
            "OFFSET": _use_weight(False, 0.03),
            "KL": _use_weight(False, 0.01),
            "BOUNDARY": _use_weight(False, 0.01),
            "DIVERSITY": _use_weight(False, 0.01, CRITERION="MSE"),
            "INTEGRAL_L1": _use_weight(False, 1.0),
            "ALIGNED_FEAT": _use_weight(False, 1.0),
            "STRUCTURE_COSINE": _use_weight(False, 1.0),
            "OPTIMAL_TRANSPORT": {
                "USE": False,
                "EPSILON": 100,
                "N_ITER": 10,
                "WEIGHT": 1,
            },
            "USE_DIFFERENT_JOINTS_WEIGHT": False,
            # MI loss coefficients (alpha/beta hardcoded at reference
            # alignment_mi_function_term6_1.py:119; surfaced as config here)
            "MI_ALPHA": 0.5,
            "MI_BETA": 0.1,
            # JHMDB config-tree compatibility (reference config/jhmdb.py:91);
            # top-k hard-pixel mining knob, unused by the shipped loss
            "TOPK": 8,
        }
    )

    # -- dataset -----------------------------------------------------------------
    c.DATASET = _node(
        {
            "RANDOM_AUX_FRAME": True,
            "ROOT": "",
            "NAME": "",
            "DATASET": "mpii",
            "TRAIN_SET": "train",
            "TEST_SET": "test",
            "VAL_SET": "val",
            "HYBRID_JOINTS_TYPE": "",
            "SELECT_DATA": False,
            "TEST_ON_TRAIN": False,
            "JSON_FILE": "",
            "JSON_DIR": "",
            "POSETRACK17_JSON_DIR": "",
            "POSETRACK18_JSON_DIR": "",
            "IMG_DIR": "",
            "POSETRACK17_IMG_DIR": "",
            "POSETRACK18_IMG_DIR": "",
            "IS_POSETRACK18": False,
            "COLOR_RGB": False,
            "TEST_IMG_DIR": "",
            "POSETRACK17_TEST_IMG_DIR": "",
            "POSETRACK18_TEST_IMG_DIR": "",
            "INPUT_TYPE": "",
            "BBOX_ENLARGE_FACTOR": 1.0,
            "USE_GLOBAL_REF": False,
            "USE_LOCAL_REF": False,
            "NUM_REF": 0,
            "SPLIT_VERSION": 1,
        }
    )

    # -- train ------------------------------------------------------------------
    c.TRAIN = _node(
        {
            "SAVE_MODEL_PER_EPOCH": 2,
            "BATCH_SIZE_PER_GPU": 32,
            "SHUFFLE": True,
            "LOSS_ALPHA": 1.0,
            "LOSS_BETA": 1.0,
            "LOSS_GAMA": 1.0,
            "LR_FACTOR": 0.1,
            "LR_STEP": [90, 110],
            "MILESTONES": [8, 12, 16],
            "GAMMA": 0.99,
            "LR": 0.001,
            "STSN_LR": 0.001,
            "OPTIMIZER": "adam",
            "MOMENTUM": 0.9,
            "WD": 0.0001,
            "NESTEROV": False,
            "GAMMA1": 0.99,
            "GAMMA2": 0.0,
            "BEGIN_EPOCH": 0,
            "END_EPOCH": 140,
            "AUTO_RESUME": False,
            "FLIP": True,
            "SCALE_FACTOR": 0.25,
            "ROT_FACTOR": 30,
            "PROB_HALF_BODY": 0.0,
            "NUM_JOINTS_HALF_BODY": 8,
            "LR_SCHEDULER": "MultiStepLR",
            "LR_SECOND_GROUP": [None],
            "LR_SECOND_GROUP_VALUE": 1e-6,
            "RANDOM_SAMPLE_IN_ENTIRE_TRACK_SEQUENCE": False,
            "SAMPLE_MAX_DISTANCE": 1,
            "BIDIRECTIONAL_SUPERVISION": False,
            "TRACK_SEQ": True,
            "TRAIN_GT_HEATMAPS_TRANSFORM": True,
            "TRAIN_AGG": False,
        }
    )

    # -- val / test -----------------------------------------------------------------
    def _eval_node(flip_key: str) -> CfgNode:
        d = {
            "BATCH_SIZE_PER_GPU": 1,
            "MODEL_FILE": "",
            "ANNOT_DIR": "",
            "COCO_BBOX_FILE": "",
            "USE_GT_BBOX": False,
            "BBOX_THRE": 1.0,
            "IMAGE_THRE": 0.1,
            "IN_VIS_THRE": 0.0,
            "NMS_THRE": 0.6,
            "OKS_THRE": 0.5,
            "SHIFT_HEATMAP": False,
            "SOFT_NMS": False,
            "POST_PROCESS": False,
            "FLIP": False,
            # also run the poseval MOTA tracking protocol in evaluate()
            # (the reference's evaluate_simple eval_track flag; its shipped
            # loop pins it False, so False stays the default)
            "EVAL_TRACK": False,
            flip_key: False,
        }
        return _node(d)

    c.VAL = _eval_node("FLIP_VAL")
    c.TEST = _eval_node("FLIP_TEST")
    c.INFERENCE = _node({"MODEL_FILE": ""})

    # -- debug -----------------------------------------------------------------
    c.DEBUG = _node(
        {
            "VIS_SKELETON": False,
            "VIS_BBOX": False,
            "DEBUG": False,
            "SAVE_BATCH_IMAGES_GT": False,
            "SAVE_BATCH_IMAGES_PRED": False,
            "SAVE_HEATMAPS_GT": False,
            "SAVE_HEATMAPS_PRED": False,
        }
    )

    return c
