"""The port's command line over two processes on the CPU (gloo), as
``tests/test_multihost.py`` drives the JAX package over two:

* ``python -m torch.distributed.run --nproc_per_node 2 -m
  fami_pose_torch.run --cfg <yaml> --train --val --device cpu TPU.MESH_SHAPE
  [-1,1]`` on the tiny fixture: exit code 0, one checkpoint, the AP tables
  logged once, by rank 0;
* ``tests/torch_dist_run.py`` under the same launcher, which runs
  ``fami_pose_torch.run.main`` in each rank and records what it saw: a
  second epoch auto-resumed from that checkpoint on both ranks (the loaded
  state equal to the file bit for bit), written by rank 0 only, the final
  states of both ranks bit for bit equal; ``--val``: scores on rank 0 only
  (``{}`` on rank 1), the same global predictions on both ranks; ``--val``
  with ``TPU.INT8_EVAL`` and ``TPU.DCN_AUTO_WINDOW`` (each rank calibrates
  on its own slice): the same int8 scales and window on both ranks.

The two-rank ``--val`` predictions are held to one process's on the same
checkpoint: keypoints within 1e-4 of the boxes' size in pixels (the
ranks' forwards run at half the batch, and the CPU's convolutions may sum
in another order at another batch size) and their scores within 1e-5.
"""

import glob
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from fami_pose_torch.config import get_cfg
from fami_pose_torch.engine.argument_parser import default_parse_args
from fami_pose_torch.engine.runner import Runner
from fixtures import make_cfg, make_posetrack_fixture
from test_end_to_end import _write_gt_annolists
from test_torch_runner import HYPER, _ap_tables, _write_yaml

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
HERE = osp.dirname(osp.abspath(__file__))
MESH = ["TPU.MESH_SHAPE", "[-1,1]"]
INT8 = ["TPU.INT8_EVAL", "True", "TPU.DCN_AUTO_WINDOW", "True",
        "TPU.INT8_CALIB_BATCHES", "1"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(target, args, cwd, env, nproc=2):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port())] + target + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The fixture (6 samples; a global train batch of 2, three steps an
    epoch; a global eval batch of 4, whose last has 2 real rows, so rank
    1's slice of it is all padding), the CLI's ``--train --val`` over two
    ranks, then the recording ranks' resume and int8 val."""
    root = str(tmp_path_factory.mktemp("two_ranks"))
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=6,
                                        people_per_frame=1)
    annot_dir = _write_gt_annolists(
        root, img_dir, make_cfg(osp.join(root, "json"), img_dir))
    cfg_path = _write_yaml(root, img_dir, annot_dir)
    with open(cfg_path) as f:
        plain = yaml.safe_load(f)
    plain["TRAIN"]["BATCH_SIZE_PER_GPU"] = 1
    plain["VAL"]["BATCH_SIZE_PER_GPU"] = 2
    with open(cfg_path, "w") as f:
        yaml.safe_dump(plain, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]),
               OMP_NUM_THREADS="1")
    cli = _torchrun(["-m", "fami_pose_torch.run"],
                    ["--cfg", cfg_path, "--train", "--val", "--device", "cpu"]
                    + MESH, root, env)
    out_dir = osp.join(root, "out", "smoke", "PoseTrack17", HYPER)
    ckpt_dir = osp.join(out_dir, "checkpoints")
    first, cli_logs = None, sorted(glob.glob(
        osp.join(out_dir, "log", "validate-*.log")))
    if cli.returncode == 0:
        first = torch.load(osp.join(ckpt_dir, "epoch_0_state.ckpt"),
                           weights_only=True)
    record_dir = osp.join(root, "records")
    os.makedirs(record_dir)
    base = ["--cfg", cfg_path, "--device", "cpu"]
    rec = _torchrun(
        [osp.join(HERE, "torch_dist_run.py"), record_dir],
        base + ["--train", "TRAIN.END_EPOCH", "2"] + MESH + ["--"]
        + base + ["--val"] + MESH + ["--"] + base + ["--val"] + MESH + INT8,
        root, env)
    records = None
    if rec.returncode == 0:
        records = [torch.load(osp.join(record_dir, f"rank{r}.pt"),
                              weights_only=False) for r in range(2)]
    return dict(root=root, cfg_path=cfg_path, cli=cli, rec=rec, env=env,
                cli_logs=[open(log).read() for log in cli_logs],
                out_dir=out_dir, ckpt_dir=ckpt_dir, first=first,
                records=records)


def test_cli_over_two_ranks(two_ranks):
    cli = two_ranks["cli"]
    assert cli.returncode == 0, (cli.stdout + cli.stderr)[-5000:]
    first = two_ranks["first"]
    # 6 samples, a global batch of 2: three steps, as one process with a
    # batch of 2 takes
    assert first["step"] == 3 and first["begin_epoch"] == 0
    # one log file a rank
    texts = two_ranks["cli_logs"]
    assert len(texts) == 2
    # every rank holds the 6 global samples' predictions; rank 0 scores
    assert all("eval forward done: 6 samples" in t for t in texts)
    assert [t for t, _ in _ap_tables(texts[0])] == ["final", "backbone"]
    assert _ap_tables(texts[1]) == []


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_resume_checkpoints_and_final_state(two_ranks):
    rec = two_ranks["rec"]
    assert rec.returncode == 0, (rec.stdout + rec.stderr)[-5000:]
    r0, r1 = two_ranks["records"]
    # both ranks resumed epoch 0's checkpoint, bit for bit the file
    for r in (r0, r1):
        (name, epoch, state), = r["resumed"]
        assert name == "epoch_0_state.ckpt" and epoch == 1
        file_state = {k: v for k, v in two_ranks["first"].items()
                      if k != "begin_epoch"}
        assert _equal(state, file_state)
    # only rank 0 wrote the second epoch's checkpoint
    assert [osp.basename(p) for p in r0["saved"]] == [
        "epoch_1_state.ckpt.tmp"]
    assert r1["saved"] == []
    assert sorted(os.listdir(two_ranks["ckpt_dir"])) == [
        "epoch_0_state.ckpt", "epoch_1_state.ckpt"]
    # the final states of both ranks, bit for bit, and the file
    assert r0["train_state"]["step"] == 6
    assert _equal(r0["train_state"], r1["train_state"])
    last = torch.load(osp.join(two_ranks["ckpt_dir"], "epoch_1_state.ckpt"),
                      weights_only=True)
    assert _equal(r0["train_state"]["model"], last["model"])


def test_val_over_two_ranks(two_ranks):
    """Scores on rank 0 only, the same global predictions on both ranks,
    and those of one process."""
    assert two_ranks["rec"].returncode == 0
    r0, r1 = two_ranks["records"]
    e0, e1 = r0["evals"][0], r1["evals"][0]
    assert set(e0["results"]) == {"final", "backbone"}
    assert e1["results"] == {} and e0["scales"] == {}
    (path,) = r0["results"][1]["val"]
    assert r1["results"][1]["val"] == {path: {}}
    for k in ("all_preds", "all_preds_bb", "all_boxes"):
        np.testing.assert_array_equal(e0[k], e1[k], err_msg=k)

    args = default_parse_args(["--cfg", two_ranks["cfg_path"], "--val",
                               "--device", "cpu"])
    runner = Runner(get_cfg(args), args)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (one,) = runner.launch(val=True)["val"].values()
    finally:
        torch.set_num_threads(before)
    ev = runner.evaluator
    np.testing.assert_array_equal(ev.all_boxes, e0["all_boxes"])
    scale = float(np.abs(ev.all_boxes[:, 2:4]).max()) * 200
    for k in ("all_preds", "all_preds_bb"):
        got, ref = e0[k], getattr(ev, k)
        np.testing.assert_allclose(got[..., :2], ref[..., :2],
                                   atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=1e-5,
                                   err_msg=k)
    assert set(one) == {"final", "backbone"}


def test_val_over_a_two_by_two_mesh(two_ranks):
    """``--val`` with ``TPU.MESH_SHAPE [2, 2]`` and ``DEBUG.VIS_SKELETON``
    on four ranks: ranks 0 and 1 load data index 0's 2 rows of each global
    batch of 4, ranks 2 and 3 data index 1's; the gather keeps one rank a
    data index, so each of the 6 samples is one row, the same on every
    rank and bit for bit the ``[-1, 1]`` two-rank run's (each forward runs
    the same 2 rows); rank 0 alone scores and draws (6 overlays, one a
    frame)."""
    assert two_ranks["rec"].returncode == 0
    root = two_ranks["root"]
    rec_dir = osp.join(root, "records_2x2")
    os.makedirs(rec_dir)
    run = _torchrun(
        [osp.join(HERE, "torch_dist_run.py"), rec_dir],
        ["--cfg", two_ranks["cfg_path"], "--device", "cpu", "--val",
         "TPU.MESH_SHAPE", "[2,2]", "DEBUG.VIS_SKELETON", "True"],
        root, two_ranks["env"], nproc=4)
    assert run.returncode == 0, (run.stdout + run.stderr)[-5000:]
    ranks = [torch.load(osp.join(rec_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    evals = [r["evals"][0] for r in ranks]
    assert [e["loader"] for e in evals] == [(0, 2, 2), (0, 2, 2), (1, 2, 2),
                                            (1, 2, 2)]
    assert set(evals[0]["results"]) == {"final", "backbone"}
    assert all(e["results"] == {} for e in evals[1:])
    two = two_ranks["records"][0]["evals"][0]
    for k in ("all_preds", "all_preds_bb", "all_boxes"):
        assert evals[0][k].shape[0] == 6
        for e in evals:
            np.testing.assert_array_equal(e[k], two[k], err_msg=k)
    (vis,) = glob.glob(osp.join(root, "out", "**", "validate_vis"),
                       recursive=True)
    drawn = [f for _, _, files in os.walk(vis) for f in files]
    assert len(drawn) == 6


def test_int8_val_over_two_ranks(two_ranks):
    """Rank 0's int8 scales and DCN window on both ranks, and the same
    global predictions."""
    assert two_ranks["rec"].returncode == 0
    r0, r1 = two_ranks["records"]
    e0, e1 = r0["evals"][1], r1["evals"][1]
    assert len(e0["scales"]) > 50 and _equal(e0["scales"], e1["scales"])
    assert all(float(v) > 0 for v in e0["scales"].values())
    assert e0["window"] == e1["window"]
    assert set(e0["results"]) == {"final", "backbone"}
    assert e1["results"] == {}
    for k in ("all_preds", "all_preds_bb", "all_boxes"):
        np.testing.assert_array_equal(e0[k], e1[k], err_msg=k)
