"""The port's trained-weights A/B tools on the CPU, at the tiny settings of
``tools/sustained_train.py --tiny``: ``tools/flip_ab.py``,
``tools/streaming_ab.py`` and ``tools/ablate_dcn_bound.py``, each through
its ``main()`` with ``--tiny --device cpu`` (the tables, then the JSON line)
or its ``run()``.

  * ``flip_ab``: each row's AP equals the port's ``Evaluator`` run directly
    with ``VAL.FLIP_VAL`` off and on on the same checkpoint, exactly (the
    same code on the same CPU). The flip-tested eval is held to JAX by
    ``tests/test_torch_evaluator.py``.
  * ``streaming_ab``: the re-primes on the drift fixture are 14 / 8 / 4 of
    20 emissions at IoU 0.9 / 0.7 / 0.5 (the JAX repository's
    ``docs/STREAMING_AB.md``), with trained and with seeded weights: they
    depend on the boxes only. The locked variant's heatmaps equal the JAX
    stream's (``fami_pose_tpu/engine/streaming.py``, one jitted step) on
    the same crops and weights within ``tests/test_torch_streaming.py``'s
    tolerance, 2e-4 relative + 2e-4 of the largest magnitude, and its
    keypoints equal the port's DARK decode of JAX's heatmaps within 1e-2
    image px (DARK's Taylor step divides the log heatmap's gradient by its
    Hessian, which magnifies the heatmaps' 2e-4: 3.9e-3 px at most here,
    where a heatmap pixel spans ~4 image px; no peak ties on these
    inputs).
  * ``ablate_dcn_bound``: its seeded rows against the JAX tool's
    (``tools/ablate_dcn_bound.py::main()``, imported by path): clipped %
    exactly (the same offsets), max |dY| within 1e-5 of the exact output's
    largest magnitude and the relative error within 1e-5 (the JAX tool's
    exact DCN is its gather implementation and its window the hat-window
    sum, which sum in other orders: 1.6e-5 of 3.9 where nothing is clipped;
    the port's two are one function with and without the clamp), the
    share of keypoints moved and the largest move exactly (argmax
    positions; no argmax tie flips on these inputs). Its trained rows on
    the checkpoint's own DCN inputs: a window above every offset equals
    the exact mode.

The checkpoint is 1 + 1 tiny epochs with flip augmentation on the drift
fixture with 40% occlusion, the recipe the card's phase ``serving-ab``
runs at W48.
"""

import importlib.util
import json
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.engine import streaming as jax_streaming
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_tpu.models.torch_remap import remap_fami_pose_state_dict
from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.models.bridge import init_weights
from fami_pose_torch.models.build import build_model
from fami_pose_torch.ops.heatmap import dark_get_final_preds
from fami_pose_torch.tools import ablate_dcn_bound, flip_ab, streaming_ab
from fami_pose_torch.tools import sustained_train as st
from fami_pose_torch.utils.registry import VAL_PHASE

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = dict(motion="drift", occlude=0.4)
CLI = ["--tiny", "--device", "cpu", "--motion", "drift", "--occlude", "0.4"]
REPRIMES = {0.9: 14, 0.7: 8, 0.5: 4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors: more threads than two only contend with the other test
    workers of a parallel run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A short flip-trained tiny checkpoint (1 + 1 epochs, the kill at the
    half) on the drift fixture."""
    root = str(tmp_path_factory.mktemp("flip_run"))
    st.write_fixture(root, **FIXTURE)
    cfg = st.recipe_cfg(root, flip=True, tiny=True, epochs=2)
    summary, _ = st.train_with_resume(root, cfg, 2, device="cpu")
    assert summary["resume"]["mismatched"] == 0
    return osp.join(root, "ckpt", "epoch_1_state.ckpt")


def _main(module, argv, capsys):
    assert module.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), "\n".join(lines[:-1])


@pytest.fixture(scope="module")
def seeded_weights(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seeded"))
    st.write_fixture(root, **FIXTURE)
    model = build_model(st.recipe_cfg(root, tiny=True), VAL_PHASE)
    with torch.no_grad():
        init_weights(model, seed=5)
    return model.state_dict()


def test_flip_ab_rows_are_the_evaluators(ckpt, tmp_path, capsys):
    rep, text = _main(flip_ab, ["--ckpt", ckpt, *CLI], capsys)
    assert [r["row"] for r in rep["rows"]] == ["noflip", "flip"]
    assert "== flip-test AP delta (flip - noflip), trained weights ==" in text
    assert "flip-noflip: Head=" in text and "[noflip] (" in text
    root = str(tmp_path)
    st.write_fixture(root, **FIXTURE)
    variables = load_variables(ckpt)
    for r in rep["rows"]:
        cfg = flip_ab.eval_cfg(root, tiny=True)
        cfg.VAL.FLIP_VAL = r["flip"]
        ev = Evaluator(cfg, output_dirs={"results": osp.join(root, r["row"])},
                       device="cpu")
        name_value, _ = ev.eval_checkpoint(variables)["final"]
        assert r["ap"] == {k: float(v) for k, v in name_value.items()}, \
            r["row"]
        assert r["samples"] == 20 and r["seconds"] > 0
        assert not any(r["launches"].values())  # plain versions on the CPU
    delta = rep["deltas"]["flip-noflip"]
    for k, v in delta.items():
        assert v == rep["rows"][1]["ap"][k] - rep["rows"][0]["ap"][k]
    assert rep["saturated"] == (rep["rows"][0]["ap"]["Mean"] > 95.0)
    # the flip pass changed the predictions
    assert rep["rows"][0]["ap"] != rep["rows"][1]["ap"]


def test_flip_ab_int8_rows_calibrate_as_the_serving_file():
    import types

    from fami_pose_torch.config import get_cfg

    names = [n for n, _ in flip_ab.row_specs(int8=True)]
    assert names == ["noflip", "flip", "noflip_int8", "flip_int8"]
    cfg = get_cfg(types.SimpleNamespace(
        cfg=osp.join(ROOT, "configs/posetrack18/fami_pose_serving.yaml"),
        opts=[], root_dir=ROOT))
    levers = flip_ab.INT8_LEVERS
    for key, value in zip(levers[0::2], levers[1::2]):
        node = cfg
        for k in key.split("."):
            node = node[k]
        assert node == value, key


@pytest.fixture(scope="module")
def stream_run(seeded_weights):
    return streaming_ab.run(seeded_weights, tiny=True, device="cpu",
                            **FIXTURE)


def test_reprime_counts_on_the_drift_fixture(stream_run, ckpt, capsys):
    """The counts of the JAX repository's table, with seeded weights (the
    ``run`` fixture) and with the trained checkpoint (``main``)."""
    seeded, _ = stream_run
    trained, text = _main(streaming_ab, ["--ckpt", ckpt, *CLI], capsys)
    for rep in (seeded, trained):
        assert rep["emissions"] == 20 and rep["streams"] == 4
        assert streaming_ab.reprime_counts(rep) == REPRIMES
        rows = {r["variant"]: r for r in rep["rows"]}
        assert list(rows) == ["batch", "locked", "reprime@0.9",
                              "reprime@0.7", "reprime@0.5"]
        assert rows["locked"]["reprimes"] == 0
        for iou, n in REPRIMES.items():
            assert rows[f"reprime@{iou}"]["reprime_rate"] == n / 20
        for r in rows.values():
            assert all(math.isfinite(v) for v in r["ap"].values())
            assert not any(r["launches"].values())
        # the boxes drift 6-10 px a frame: locked crops miss the batch's
        assert rep["drift_px"]["mean"] > 0
    assert "re-primes / 20 emissions" in text
    assert "keypoint drift batch-vs-locked" in text


def test_batch_variant_is_the_evaluators_protocol(stream_run,
                                                  seeded_weights, tmp_path):
    """The tool's batch protocol (host crops and normalisation, one forward
    of the 20 samples) predicts what the evaluator does without flip-test
    (batches of 4, normalised by torch), within 1e-3 image px."""
    rep, ex = stream_run
    root = str(tmp_path)
    st.write_fixture(root, **FIXTURE)
    ev = Evaluator(flip_ab.eval_cfg(root, tiny=True),
                   output_dirs={"results": root}, device="cpu")
    name_value, _ = ev.eval_checkpoint(seeded_weights)["final"]
    np.testing.assert_allclose(ex["batch_preds"][:, :, :2],
                               ev.all_preds[:, :, :2], rtol=0, atol=1e-3)
    assert rep["rows"][0]["variant"] == "batch"
    assert set(rep["rows"][0]["ap"]) == set(dict(name_value))


def test_locked_stream_matches_the_jax_stream(stream_run, seeded_weights):
    """Every emission of the locked variant against the JAX stream's step on
    the same locked crops and the same weights (bridged by the reference
    names)."""
    _, ex = stream_run
    params, stats, unmapped = remap_fami_pose_state_dict(
        {k: v.numpy() for k, v in seeded_weights.items()})
    assert unmapped == []
    variables = {"params": params, "batch_stats": stats}
    jm = JaxFAMIPose(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
                     dcn_offset_groups=4, dcn_max_offset=2)
    frames, hms, d = ex["frames"], ex["hms"], ex["distance"]
    step = jax.jit(jax_streaming.make_step(jm, variables, d))
    state = jax_streaming.init_state(jm, variables, jnp.asarray(frames[0]), d)
    n_t, lat = frames.shape[0], d - 1
    got = []
    for t in range(n_t + lat):
        state, (hm, _) = step(state, jnp.asarray(frames[min(t, n_t - 1)]))
        if t >= lat:
            got.append(np.transpose(np.asarray(hm), (0, 3, 1, 2)))
    got = np.stack(got)
    assert got.shape == hms.shape
    np.testing.assert_allclose(hms, got, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(got).max())))
    # the keypoints: the port's decode of the JAX heatmaps at each emission
    ref = np.stack([dark_get_final_preds(torch.from_numpy(h),
                                         ex["lock_center"],
                                         ex["lock_scale"])[0].numpy()
                    for h in got])
    port = np.stack([dark_get_final_preds(torch.from_numpy(h),
                                          ex["lock_center"],
                                          ex["lock_scale"])[0].numpy()
                     for h in hms])
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-2)
    # and those are the rows the tool scored
    assert np.isin(ex["preds"][:, :, :2], port).all()


def _jax_ablation():
    spec = importlib.util.spec_from_file_location(
        "jax_ablate_dcn_bound", osp.join(ROOT, "tools", "ablate_dcn_bound.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


def test_ablation_matches_the_jax_tool(ckpt, capsys):
    rep, text = _main(ablate_dcn_bound,
                      ["--offsets-from", ckpt, *CLI], capsys)
    assert "clip%" in text and "trained dcn_1" in text
    seeded = [r for r in rep["rows"] if isinstance(r["sigma"], float)]
    ref = _jax_ablation()
    capsys.readouterr()
    assert len(seeded) == len(ref) == 10
    for r, (sigma, d, clip, dev, rel, moved, px) in zip(seeded, ref):
        assert (r["sigma"], r["D"]) == (sigma, d)
        assert r["clip_pct"] == clip
        np.testing.assert_allclose(r["max_dev"], dev, rtol=0,
                                   atol=1e-5 * r["scale"])
        np.testing.assert_allclose(r["rel_err"], rel, rtol=0, atol=1e-5)
        assert r["kpt_moved_pct"] == moved and r["kpt_max_px"] == px
        assert r["dtype"] == "float32" and r["shape"] == [2, 48, 96, 72]
        assert not any(r["launches"].values())
    # the windows only clamp once the offsets pass them
    assert seeded[0]["max_dev"] == 0 and seeded[-1]["clip_pct"] > 40


def test_ablation_trained_rows(ckpt):
    """One row per window and DCN stage on the checkpoint's own inputs; a
    window above every offset equals the exact mode."""
    rep, stages = ablate_dcn_bound.run(ckpt, tiny=True, device="cpu",
                                       **FIXTURE)
    trained = [r for r in rep["rows"] if not isinstance(r["sigma"], float)]
    assert [(r["sigma"], r["D"]) for r in trained] == [
        (f"trained dcn_{i}", d) for d in (4, 6) for i in range(1, 5)]
    assert sorted(stages) == [f"dcn_{i}" for i in range(1, 5)]
    x, off, msk, wgt = stages["dcn_1"]
    assert x.shape[0] == 4 and off.shape[1] == 2 * 9 * 4
    for r in trained:
        assert r["dtype"] == "float32" and r["shape"] == list(
            stages[r["sigma"][8:]][0].shape)
        if r["offsets_abs_max"] <= r["D"]:
            assert r["clip_pct"] == 0 and r["max_dev"] == 0
            assert r["kpt_moved_pct"] == 0
    assert not any(rep["capture_launches"].values())
    json.dumps(rep)
