"""Reference PyTorch checkpoints into the port (``models/pretrained.py``)
against the JAX package's remap (``fami_pose_tpu/models/torch_remap.py``),
and the two tools that use it (``python -m fami_pose_torch.tools.
convert_model`` / ``validate_real_checkpoint``), on ``.pth`` files written
here in the reference's layouts.

The weights are random flax variables at the tiny topology, carried to
reference names by the weight bridge. Each ``.pth`` holds what a reference
file holds: ``module.`` prefixes (a DataParallel model), a ``state_dict``
wrapper (the full model's ``{begin_epoch, state_dict, optimizer}`` payload),
``num_batches_tracked`` counters, and keys that neither remap knows.

Tolerances: the loaded ``state_dict`` equals JAX's remap + overlay, carried
back by the bridge, bit for bit, and the unmapped lists are equal as lists;
the trainer's backbone after ``MODEL.PRETRAINED`` equals the file bit for
bit; the tool's AP tables equal the evaluator's on the same weights exactly.
"""

import json
import logging
import os
import os.path as osp
import subprocess
import sys
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fami_pose_tpu.models import torch_remap as jax_remap
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_torch.engine import checkpoints
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.engine.trainer import Trainer
from fami_pose_torch.models import pretrained
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.tools import convert_model, validate_real_checkpoint
from fixtures import make_cfg, make_posetrack_fixture
from test_end_to_end import _write_gt_annolists
from torch_port_helpers import random_variables

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4)
# keys of real files that neither remap maps: an ImageNet classifier's and
# incremental modules' (a classification HRNet), and a head that is not
# the port's
FOREIGN_BACKBONE = ("incre_modules.0.0.conv1.weight", "fc.weight")
FOREIGN_FULL = ("extra_head.weight", "hrnet.fc.weight")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _variables(seed, hw=64):
    init = JaxFAMIPose(**JAX_KW)
    return random_variables(
        lambda k: init.init(k, jnp.zeros((1, hw, hw, 3)),
                            jnp.zeros((1, hw, hw, 12)), train=False),
        seed=seed)


@pytest.fixture(scope="module")
def weights():
    """The file's weights and the model's own (the template overlaid), as
    flax variables and as reference-named port state dicts."""
    file_vars, model_vars = _variables(11), _variables(12)
    return dict(file_vars=file_vars, model_vars=model_vars,
                file_sd=state_dict_from_flax(file_vars),
                model_sd=state_dict_from_flax(model_vars))


def _with_counters(sd):
    """A reference state dict: each BatchNorm gets its
    ``num_batches_tracked``, as ``nn.BatchNorm2d`` saves it."""
    out = OrderedDict()
    for k, v in sd.items():
        out[k] = v.clone()
        if k.endswith("running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    return out


def backbone_pth(path, file_sd, foreign=FOREIGN_BACKBONE):
    """A ``pose_hrnet_w48.pth``-style file: bare HRNet names (the shared
    ``final_layer`` included) under ``module.``, in a ``state_dict``
    wrapper, with counters and foreign keys."""
    sd = _with_counters(OrderedDict(
        (k[len("hrnet."):], v) for k, v in file_sd.items()
        if k.startswith("hrnet.")))
    for i, k in enumerate(foreign):
        sd[k] = torch.full((3, 2), float(i))
    torch.save({"state_dict": OrderedDict(
        ("module." + k, v) for k, v in sd.items())}, path)
    return path


def full_pth(path, file_sd, foreign=FOREIGN_FULL):
    """An ``epoch_20_state.pth``: the reference payload ``{begin_epoch,
    state_dict, optimizer}`` around a DataParallel ``Alignment_V15`` state
    dict with counters and foreign keys."""
    sd = _with_counters(file_sd)
    for i, k in enumerate(foreign):
        sd[k] = torch.full((2,), float(i))
    torch.save({
        "begin_epoch": 21,
        "state_dict": OrderedDict(("module." + k, v) for k, v in sd.items()),
        "optimizer": {"state": {0: {"step": torch.tensor(3.0),
                                    "exp_avg": torch.zeros(2)}},
                      "param_groups": [{"lr": 1e-3, "params": [0]}]},
    }, path)
    return path


def _jax_loaded(path, full, model_vars):
    """JAX's remap + overlay of the file, carried to port names."""
    sd = jax_remap.load_torch_state_dict(path)
    remap = (jax_remap.remap_fami_pose_state_dict if full
             else jax_remap.remap_hrnet_backbone_for_fami)
    params, stats, unmapped = remap(sd)
    merged = jax_remap.merge_into_variables(model_vars, params, stats)
    return state_dict_from_flax(merged), unmapped


@pytest.mark.parametrize("full", [False, True], ids=["backbone", "full"])
def test_loader_matches_jax_remap_bitwise(tmp_path, weights, full):
    path = str(tmp_path / "w.pth")
    (full_pth if full else backbone_pth)(path, weights["file_sd"])
    sd = pretrained.load_torch_state_dict(path)
    assert not any(k.startswith("module.") for k in sd)
    remap = (pretrained.remap_fami_pose_state_dict if full
             else pretrained.remap_hrnet_backbone_for_fami)
    mapped, unmapped = remap(sd)
    got = pretrained.merge_into_variables(weights["model_sd"], mapped)
    want, jax_unmapped = _jax_loaded(path, full, weights["model_vars"])

    assert unmapped == jax_unmapped
    assert unmapped == list(FOREIGN_FULL if full else FOREIGN_BACKBONE)
    assert list(got) == list(weights["model_sd"])
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # what the file holds landed; the rest is the model's own
    for k, v in got.items():
        from_file = full or k.startswith("hrnet.")
        src = weights["file_sd"] if from_file else weights["model_sd"]
        assert torch.equal(v, src[k]), k
    assert not any("num_batches_tracked" in k for k in mapped)


def test_backbone_keys_with_hrnet_prefix_and_standalone_names(weights):
    """``hrnet.``-prefixed backbone names map as bare ones (the JAX remap
    strips the prefix); ``remap_hrnet_state_dict`` without a prefix gives
    the standalone HRNet's names; the counters are skipped, not listed."""
    sd = _with_counters(OrderedDict(
        (k, v) for k, v in weights["file_sd"].items()
        if k.startswith("hrnet.")))
    mapped, unmapped = pretrained.remap_hrnet_backbone_for_fami(sd)
    assert unmapped == [] and list(mapped) == [
        k for k in sd if "num_batches_tracked" not in k]
    bare, _ = pretrained.remap_hrnet_state_dict(
        OrderedDict((k[len("hrnet."):], v) for k, v in sd.items()))
    assert list(bare) == [k[len("hrnet."):] for k in mapped]
    np_sd = {k: v.numpy() for k, v in sd.items()}
    _, _, jax_unmapped = jax_remap.remap_hrnet_backbone_for_fami(np_sd)
    assert jax_unmapped == unmapped


def test_overlay_errors_match_jax(weights):
    """A key the remap maps but the model lacks raises ``KeyError``, a
    shape that differs ``ValueError``, in both packages."""
    file_sd = weights["file_sd"]
    model_vars, model_sd = weights["model_vars"], weights["model_sd"]
    unknown = OrderedDict(
        [("layer1.0.conv4.weight", torch.zeros(64, 64, 1, 1))])
    wrong = OrderedDict(
        [("conv1.weight", torch.zeros_like(file_sd["hrnet.conv1.weight"])[:, :2])])
    for sd, error in ((unknown, KeyError), (wrong, ValueError)):
        mapped, _ = pretrained.remap_hrnet_backbone_for_fami(sd)
        with pytest.raises(error):
            pretrained.merge_into_variables(model_sd, mapped)
        params, stats, _ = jax_remap.remap_hrnet_backbone_for_fami(
            {k: v.numpy() for k, v in sd.items()})
        with pytest.raises(error):
            jax_remap.merge_into_variables(model_vars, params, stats)


class _NotATensor:
    pass


def test_a_file_that_needs_unpickling_is_refused(tmp_path):
    path = str(tmp_path / "pickled.pth")
    torch.save({"state_dict": {"conv1.weight": torch.zeros(1)},
                "extra": _NotATensor()}, path)
    with pytest.raises(ValueError, match="pickled.pth"):
        pretrained.load_torch_state_dict(path)


def _trainer_cfg(root, pretrained_path=""):
    from fami_pose_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.NAME = "FAMIPose"
    cfg.MODEL.EXTRA = TINY_EXTRA
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.PRETRAINED = pretrained_path
    cfg.MODEL.INIT_WEIGHTS = True
    cfg.DISTANCE = 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DCN_OFFSET_GROUPS = 4
    cfg.TPU.DCN_MAX_OFFSET = 2
    cfg.TPU.MESH_SHAPE = [1, 1]
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.WORKERS = 1
    cfg.OUTPUT_DIR = osp.join(root, "out")
    return cfg


def test_trainer_loads_pretrained_backbone(tmp_path, weights, caplog):
    """``MODEL.PRETRAINED`` overlays the backbone after the seeded init and
    ``MODEL.INIT_WEIGHTS``: ``hrnet.*`` is the file's bit for bit, the head
    is what the trainer makes without the file; the unmapped count is
    logged; then a train step runs."""
    from chip_smoke import SyntheticPoseDataset

    path = backbone_pth(str(tmp_path / "hrnet.pth"), weights["file_sd"])
    dataset = SyntheticPoseDataset(2, (64, 64), 4)
    plain = Trainer(_trainer_cfg(str(tmp_path / "a")), dataset=dataset,
                    device="cpu").model.state_dict()
    with caplog.at_level(logging.INFO):
        trainer = Trainer(_trainer_cfg(str(tmp_path / "b"), path),
                          dataset=dataset, device="cpu")
    assert f"loaded pretrained backbone from {path} (2 unmapped keys)" \
        in caplog.text
    got = trainer.model.state_dict()
    for k, v in got.items():
        want = weights["file_sd"][k] if k.startswith("hrnet.") else plain[k]
        assert torch.equal(v, want), k
    trainer.train()
    assert trainer.state.step == 1


def test_convert_model_writes_a_port_checkpoint(tmp_path, weights):
    """``--nested-under-hrnet`` names the tensors as the FAMIPose model
    does, without it as the standalone HRNet; ``load_variables`` reads the
    result; the tensors are the file's bit for bit. Once through
    ``python -m`` as a user runs it."""
    src = backbone_pth(str(tmp_path / "hrnet.pth"), weights["file_sd"])
    hrnet = {k: v for k, v in weights["file_sd"].items()
             if k.startswith("hrnet.")}
    nested = str(tmp_path / "nested.ckpt")
    convert_model.main(["--torch", src, "--out", nested,
                        "--nested-under-hrnet"])
    got = checkpoints.load_variables(nested)
    assert list(got) == list(hrnet)
    assert all(torch.equal(got[k], hrnet[k]) for k in got)

    bare = str(tmp_path / "bare.ckpt")
    out = subprocess.run(
        [sys.executable, "-m", "fami_pose_torch.tools.convert_model",
         "--torch", src, "--out", bare], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert f"mapped {len(hrnet)} arrays; 2 unmapped torch keys" in out.stdout
    got = checkpoints.load_variables(bare)
    assert list(got) == [k[len("hrnet."):] for k in hrnet]
    assert all(torch.equal(got[k], hrnet["hrnet." + k]) for k in got)


@pytest.fixture(scope="module")
def val_world(tmp_path_factory):
    """A PoseTrack17 fixture with GT annolists and a complete yaml of the
    tiny model on it."""
    root = str(tmp_path_factory.mktemp("validate"))
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=4,
                                        people_per_frame=2)
    json_dir = osp.join(root, "json")
    annot_dir = _write_gt_annolists(root, img_dir, make_cfg(json_dir, img_dir))
    cfg = {
        "OUTPUT_DIR": osp.join(root, "out"), "WORKERS": 1, "DISTANCE": 3,
        "DATASET": {"NAME": "PoseTrack", "JSON_DIR": json_dir,
                    "IMG_DIR": img_dir, "TEST_IMG_DIR": img_dir,
                    "IS_POSETRACK18": False, "COLOR_RGB": True,
                    "BBOX_ENLARGE_FACTOR": 1.25},
        "MODEL": {"NAME": "Alignment_V15", "NUM_JOINTS": 17,
                  "IMAGE_SIZE": [96, 128], "HEATMAP_SIZE": [24, 32],
                  "SIGMA": 2, "EXTRA": TINY_EXTRA},
        "VAL": {"ANNOT_DIR": annot_dir, "USE_GT_BBOX": True,
                "BATCH_SIZE_PER_GPU": 4, "FLIP_VAL": True},
        "TPU": {"COMPUTE_DTYPE": "float32", "DCN_OFFSET_GROUPS": 4,
                "DCN_MAX_OFFSET": 2, "MESH_SHAPE": [1, 1]},
    }
    cfg_path = osp.join(root, "fixture.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return dict(root=root, cfg=cfg_path, json_dir=json_dir, img_dir=img_dir)


def _variables_at(seed, h, w):
    init = JaxFAMIPose(**JAX_KW)
    return random_variables(
        lambda k: init.init(k, jnp.zeros((1, h, w, 3)),
                            jnp.zeros((1, h, w, 12)), train=False), seed=seed)


@pytest.mark.parametrize("bound", [0, 2], ids=["exact", "window2"])
def test_validate_real_checkpoint_on_the_fixture(tmp_path, val_world, bound,
                                                 capsys):
    """The tool on a full ``epoch_20_state.pth``: ``full`` with its two
    foreign keys reported, the DCN in the exact mode (or at
    ``--dcn-bound``), and per joint the AP that the port's ``Evaluator``
    gives on the same weights; ``--reference-scores`` prints the delta and
    the 0.1 target."""
    file_sd = state_dict_from_flax(_variables_at(13, 128, 96))
    path = full_pth(str(tmp_path / "epoch_20_state.pth"), file_sd)
    ref_scores = str(tmp_path / "ref.json")
    results = validate_real_checkpoint.main(
        ["--checkpoint", path, "--cfg", val_world["cfg"], "--device", "cpu",
         "--dcn-bound", str(bound), "OUTPUT_DIR",
         str(tmp_path / "tool_out")])
    out = capsys.readouterr().out
    assert f"loaded full checkpoint {path} (2 unmapped torch keys)" in out
    assert f"DCN window: {bound if bound else 'exact'}" in out
    name_value, _ = results["final"]
    assert list(name_value) == ["Head", "Shoulder", "Elbow", "Wrist", "Hip",
                                "Knee", "Ankle", "Mean"]
    assert all(np.isfinite(v) for v in name_value.values())
    for k, v in name_value.items():
        assert f"  {k:10s} {v:6.2f}" in out

    # the same weights through the evaluator itself
    from fami_pose_torch.config import get_cfg
    import types

    cfg = get_cfg(types.SimpleNamespace(
        cfg=val_world["cfg"], root_dir=".",
        opts=["TPU.DCN_MAX_OFFSET", bound, "OUTPUT_DIR",
              str(tmp_path / "ev_out")]))
    ev = Evaluator(cfg, device="cpu")
    assert ev.dcn_max_offset == (bound or None)
    want = ev.eval_checkpoint(file_sd)
    for tag in ("final", "backbone"):
        assert dict(results[tag][0]) == dict(want[tag][0]), tag

    with open(ref_scores, "w") as f:
        json.dump({k: v + 0.05 for k, v in name_value.items()}, f)
    validate_real_checkpoint.main(
        ["--checkpoint", path, "--cfg", val_world["cfg"], "--device", "cpu",
         "--dcn-bound", str(bound), "--reference-scores", ref_scores,
         "OUTPUT_DIR", str(tmp_path / "tool_out2")])
    out = capsys.readouterr().out
    assert "delta vs reference:" in out
    assert "worst |delta| = 0.050 (within the 0.1 target)" in out


def test_validate_real_checkpoint_backbone_only(tmp_path, val_world,
                                                capsys):
    """A backbone-only file is recognised as such and loads the backbone;
    the head keeps the model's own (seeded) parameters."""
    file_sd = state_dict_from_flax(_variables_at(14, 128, 96))
    path = backbone_pth(str(tmp_path / "pose_hrnet.pth"), file_sd)
    from fami_pose_torch.config import get_cfg
    import types

    cfg = get_cfg(types.SimpleNamespace(cfg=val_world["cfg"], root_dir=".",
                                        opts=None))
    ev = Evaluator(cfg, device="cpu")
    variables, kind, unmapped = validate_real_checkpoint.load_and_remap(
        path, ev.model)
    assert kind == "backbone" and unmapped == list(FOREIGN_BACKBONE)
    own = ev.model.state_dict()
    for k, v in variables.items():
        want = file_sd[k] if k.startswith("hrnet.") else own[k]
        assert torch.equal(v, want), k
