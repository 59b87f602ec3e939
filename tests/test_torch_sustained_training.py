"""The port's sustained-training tools on the CPU: its copy of the synthetic
fixture against ``tests/fixtures.py`` (bytes), ``tools/sustained_train.py``
at the tiny settings of ``tests/test_sustained_training.py`` with the kill
at the half (the bitwise resume, a continuous metrics stream; the full 20 +
20-epoch convergence run is ``slow``), ``tools/ab_dcn_bound.py`` on its
checkpoint (the captured offsets against the JAX model's offset convs on
the same weights, the window that covers every offset against exact, a
window that clamps) and ``tools/int8_numerics.py --ckpt``.

Offsets and masks of a few tiny epochs stay near their zero start
(~1e-4), so the A/B runs on that checkpoint with its offset convs' biases
shifted by a seeded draw of up to ±3 px, so that some offsets pass 1 px,
and its mask convs' by 1, so that the DCN's output depends on them.
"""

import json
import math
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.torch_remap import remap_fami_pose_state_dict
from fami_pose_torch.config import get_cfg
from fami_pose_torch.data.loader import collate, prepare_eval_inputs
from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.models.build import build_model
from fami_pose_torch.models.hrnet import TINY_EXTRA
from fami_pose_torch.tools import ab_dcn_bound, int8_numerics
from fami_pose_torch.tools import sustained_train as st
from fami_pose_torch.tools import synthetic_fixture
from fami_pose_torch.utils.registry import DATASET_REGISTRY, VAL_PHASE
from fixtures import make_posetrack_fixture
from torch_port_helpers import nhwc

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SHORT_EPOCHS = 6  # 3 + 3, the kill at the half
OFFSET_SHIFT = 3.0  # px, the largest bias shift of the A/B's checkpoint


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors: more threads than two only contend with the other test
    workers of a parallel run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = osp.join(d, n)
            with open(p, "rb") as f:
                out[osp.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(motion=None, occlude=0.0), dict(motion=None, occlude=0.4),
    dict(motion="drift", occlude=0.0), dict(motion="drift", occlude=0.4),
    dict(motion="articulated", occlude=0.0),
    dict(motion="articulated", occlude=0.4),
    dict(posetrack18=True, motion="articulated", occlude=0.4),
], ids=["none", "none-occlude", "drift", "drift-occlude", "articulated",
        "articulated-occlude", "pt18"])
def test_fixture_writes_the_test_helpers_bytes(tmp_path, kw):
    """The same seed and arguments give the same jpeg and json bytes as
    ``tests/fixtures.py``, so a checkpoint's fixture is regenerated."""
    args = dict(n_videos=2, n_frames=5, people_per_frame=2, seed=3,
                draw_joints=True, **kw)
    got = synthetic_fixture.make_posetrack_fixture(str(tmp_path / "port"),
                                                   **args)
    want = make_posetrack_fixture(str(tmp_path / "jax"), **args)
    assert [osp.relpath(p, str(tmp_path / "port")) for p in got] == \
        [osp.relpath(p, str(tmp_path / "jax")) for p in want]
    a, b = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert len(a) == 2 * 5 + 2
    assert a == b


def test_make_cfg_is_the_test_helpers(tmp_path):
    """``make_cfg`` sets what ``tests/fixtures.py::make_cfg`` sets."""
    from fixtures import make_cfg as jax_make_cfg

    port = synthetic_fixture.make_cfg("j", "i", posetrack18=True, distance=2)
    ref = jax_make_cfg("j", "i", posetrack18=True, distance=2)
    for key in ("DISTANCE", "MODEL.NUM_JOINTS", "MODEL.IMAGE_SIZE",
                "MODEL.HEATMAP_SIZE", "MODEL.SIGMA", "DATASET.NAME",
                "DATASET.JSON_DIR", "DATASET.IMG_DIR", "DATASET.TEST_IMG_DIR",
                "DATASET.IS_POSETRACK18", "DATASET.COLOR_RGB",
                "DATASET.BBOX_ENLARGE_FACTOR", "TRAIN.PROB_HALF_BODY",
                "VAL.USE_GT_BBOX", "WORKERS"):
        a, b = port, ref
        for k in key.split("."):
            a, b = a[k], b[k]
        assert a == b, key


def _run(root, epochs):
    st.write_fixture(root)
    cfg = st.recipe_cfg(root, tiny=True, epochs=epochs)
    return st.train_with_resume(root, cfg, epochs, device="cpu")


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """The tool's two phases at the tiny settings, 3 + 3 epochs."""
    root = str(tmp_path_factory.mktemp("sustain"))
    summary, trainer = _run(root, SHORT_EPOCHS)
    return root, summary, trainer


def test_resume_is_bitwise(short_run):
    _, summary, trainer = short_run
    r = summary["resume"]
    spe = summary["steps_per_epoch"]
    assert spe == 2
    assert (r["begin_epoch"], r["step"]) == (SHORT_EPOCHS // 2,
                                             SHORT_EPOCHS // 2 * spe)
    # parameters, buffers, Adam's two moments and step a parameter, the
    # groups' settings, the scheduler and the step
    n_params = len(list(trainer.model.parameters()))
    assert r["entries"] > len(trainer.model.state_dict()) + 3 * n_params
    assert r["mismatched"] == 0 and r["mismatched_names"] == []
    assert int(trainer.state.step) == SHORT_EPOCHS * spe


def test_metrics_stream_is_continuous_across_the_resume(short_run):
    _, summary, _ = short_run
    steps = SHORT_EPOCHS * summary["steps_per_epoch"]
    assert summary["logs"] == steps and summary["last_logged_step"] == steps
    assert summary["max_log_gap"] <= summary["steps_per_epoch"]
    assert summary["step_ms"]["steps"] == steps
    assert 0 < summary["step_ms"]["min"] <= summary["step_ms"]["median"] \
        <= summary["step_ms"]["max"]
    assert all(math.isfinite(summary[k]) for k in
               ("loss_first5", "loss_last5", "pck_first5", "pck_last5"))


def test_checkpoints_kept_are_epoch_0_and_each_phase_end(short_run):
    root, _, _ = short_run
    half = SHORT_EPOCHS // 2
    assert sorted(os.listdir(osp.join(root, "ckpt"))) == sorted(
        f"epoch_{e}_state.ckpt" for e in (0, half - 1, SHORT_EPOCHS - 1))


def test_resume_check_names_every_changed_entry(short_run):
    """A changed parameter, Adam moment, scheduler entry or step each show
    as a difference; a copy shows none."""
    _, _, trainer = short_run
    a = st.snapshot(trainer.state)
    assert st.differing(a, st.snapshot(trainer.state)) == []
    b = st.snapshot(trainer.state)
    pname = next(k for k in b if k.startswith("model/"))
    b[pname] = b[pname].clone()
    b[pname].view(-1)[0] = torch.nextafter(b[pname].view(-1)[0],
                                           torch.tensor(math.inf))
    moment = next(k for k in b if k.endswith("/exp_avg_sq"))
    b[moment] = b[moment] * 2
    b["scheduler/last_epoch"] += 1
    b["step"] += 1
    b["model/extra"] = torch.zeros(1)
    assert st.differing(a, b) == sorted(
        [pname, moment, "scheduler/last_epoch", "step", "model/extra"])


def test_report_prints_the_jax_tools_lines(short_run, capsys):
    _, summary, _ = short_run
    assert st.report(summary, min_pck=-1.0)
    out = capsys.readouterr().out
    for line in ("steps: 12 total, resume at 6", "loss: ",
                 "final PCK (train meter, last 5 logs): ",
                 "max log-step gap: ", "PASS: overfit PCK > -1.0, bitwise "
                 "resume continuity ok"):
        assert line in out
    assert not st.report(summary, min_pck=1.0)


@pytest.mark.slow
def test_sustained_training_converges_with_a_midrun_resume(tmp_path):
    """The thresholds of ``tests/test_sustained_training.py``: 20 + 20
    epochs of the tiny model."""
    summary, _ = _run(str(tmp_path), 40)
    assert summary["resume"]["mismatched"] == 0
    assert summary["last_logged_step"] >= 39 * summary["steps_per_epoch"]
    assert summary["loss_last5"] < 0.8 * summary["loss_first5"]
    assert summary["pck_last5"] > 0.08
    assert summary["pck_last5"] > 2 * summary["pck_first5"]
    assert summary["max_log_gap"] <= summary["steps_per_epoch"]


@pytest.fixture(scope="module")
def shifted_ckpt(short_run):
    """The run's last checkpoint with each offset conv's bias shifted by a
    seeded draw in ±``OFFSET_SHIFT`` px and each mask conv's by 1."""
    root, _, _ = short_run
    path = osp.join(root, "ckpt", f"epoch_{SHORT_EPOCHS - 1}_state.ckpt")
    payload = torch.load(path, weights_only=True)
    rs = np.random.RandomState(14)
    for i in range(1, 5):
        b = payload["model"][f"dcn_offset_{i}.conv.bias"]
        b += torch.from_numpy(rs.uniform(-OFFSET_SHIFT, OFFSET_SHIFT,
                                         b.shape).astype(np.float32))
        # the masks start at ~0 too, which would hide what the offsets do
        payload["model"][f"dcn_mask_{i}.conv.bias"] += 1.0
    out = osp.join(root, "shifted.ckpt")
    torch.save(payload, out)
    return out


@pytest.fixture(scope="module")
def ab_report(shifted_ckpt):
    return ab_dcn_bound.run(shifted_ckpt, bounds=(1,), tiny=True,
                            device="cpu")[0]


def test_captured_offsets_are_the_jax_models_offset_convs(shifted_ckpt,
                                                         tmp_path):
    """One eval forward of the tiny model on a fixture batch: the offsets
    ``dcn_1..4`` are fed equal the JAX model's ``dcn_offset_i`` outputs on
    the same weights (bridged by the reference-name remap), 1e-5 of
    scale."""
    root = str(tmp_path)
    st.write_fixture(root)
    cfg = st.recipe_cfg(root, tiny=True)
    ds = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, VAL_PHASE)
    raw = collate([ds[i] for i in range(4)])
    kf, sup = prepare_eval_inputs(raw["kf"], raw["sup"])
    sd = load_variables(shifted_ckpt)
    model = build_model(cfg, VAL_PHASE)
    model.load_state_dict(sd)
    model.eval()
    got = ab_dcn_bound.capture_offsets(model, kf, sup)

    params, stats, unmapped = remap_fami_pose_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert unmapped == []
    jm = JaxFAMIPose(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
                     dcn_offset_groups=4, dcn_max_offset=2)
    _, inter = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, train=False, capture_intermediates=lambda mdl, _: (
            mdl.name or "").startswith("dcn_offset_")))(
        {"params": params, "batch_stats": stats},
        nhwc(kf), nhwc(sup))
    for i, g in enumerate(got, 1):
        ref = np.asarray(inter["intermediates"][f"dcn_offset_{i}"]
                         ["__call__"][0])
        assert ref.shape == nhwc(g).shape
        scale = max(1.0, float(np.abs(ref).max()))
        assert scale > 1.0  # the shifted biases carry offsets past 1 px
        np.testing.assert_allclose(nhwc(g), ref, rtol=0, atol=1e-5 * scale)


def test_offset_distribution_covers_every_dcn_input(ab_report):
    o = ab_report["offsets"]
    # 20 samples, 4 stages, 2 * 9 * 4 offset channels over the 32x24 plane
    assert o["count"] == 20 * 4 * 72 * 32 * 24
    assert 1.0 < o["max"] <= 4.0 + OFFSET_SHIFT
    assert o["share>1"] > 0 and o["p50"] <= o["p95"] <= o["p99"] <= o["max"]
    assert ab_report["cover_window"] == math.ceil(o["max"])


def test_a_window_covering_every_offset_equals_exact(ab_report):
    rows = {r["row"]: r for r in ab_report["rows"]}
    exact = rows["exact"]
    cover = rows[f"cover D={ab_report['cover_window']}"]
    assert cover["window"] == ab_report["cover_window"]
    assert cover["clamped_share"] == 0.0
    assert cover["ap"] == exact["ap"]
    assert cover["drift_px"] == dict(p50=0.0, p95=0.0, max=0.0)
    assert all(v == 0.0 for v in cover["ap_delta"].values())
    assert exact["window"] is None and "Mean" in exact["ap"]


def test_window_one_clamps(ab_report):
    row = next(r for r in ab_report["rows"] if r["row"] == "D=1")
    assert row["window"] == 1 and row["clamped_share"] > 0
    assert row["drift_px"]["max"] > 0


def test_auto_int8_and_serving_rows(ab_report):
    """The auto window covers all but ``DCN_AUTO_WINDOW_EPS`` of the
    offsets; the int8 rows run at their windows; every row is scored."""
    rows = {r["row"]: r for r in ab_report["rows"]}
    assert list(rows) == ["exact", "D=1", f"cover D="
                          f"{ab_report['cover_window']}", "auto", "int8 D=4",
                          "serving"]
    assert rows["auto"]["clamped_share"] <= 1e-3
    assert 1 <= rows["auto"]["window"] <= ab_report["cover_window"]
    assert rows["int8 D=4"]["window"] == 4
    # measured on the int8 numerics, which move the offsets a little
    assert 1 <= rows["serving"]["window"] <= 8
    for r in rows.values():
        assert all(math.isfinite(v) for v in r["ap"].values())
    json.dumps(ab_report)


def test_serving_levers_are_the_serving_files():
    import types

    cfg = get_cfg(types.SimpleNamespace(
        cfg=osp.join(ROOT, "configs/posetrack18/fami_pose_serving.yaml"),
        opts=[], root_dir=ROOT))
    levers = ab_dcn_bound.SERVING_LEVERS
    for key, value in zip(levers[0::2], levers[1::2]):
        node = cfg
        for k in key.split("."):
            node = node[k]
        assert node == value, key


def test_skip_ap_predictions_are_the_evaluators(shifted_ckpt, ab_report,
                                                capsys):
    """``--skip-ap`` runs the forwards alone; its drift is the scored
    run's, row by row, and the last line is the report."""
    assert ab_dcn_bound.main(["--ckpt", shifted_ckpt, "--tiny", "--bounds",
                              "1", "--skip-ap", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["row"] for r in rep["rows"]] == \
        [r["row"] for r in ab_report["rows"]]
    for a, b in zip(rep["rows"], ab_report["rows"]):
        assert a["ap"] is None and a["window"] == b["window"]
        assert a["drift_px"] == b["drift_px"], a["row"]


def test_int8_numerics_on_the_checkpoint(short_run, capsys):
    root, _, _ = short_run
    ckpt = osp.join(root, "ckpt", f"epoch_{SHORT_EPOCHS - 1}_state.ckpt")
    assert int8_numerics.main(["--ckpt", ckpt, "--tiny", "--batch", "2",
                               "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["drift_unit"] == "image px" and rep["batch"] == 2
    assert rep["weights"] == f"trained: {ckpt}"
    assert rep["int8_convs"] > 0
    for head in ("final", "backbone"):
        for row in rep["pairs"][head].values():
            assert all(np.isfinite(v) for v in row.values())
