"""Streaming serving on the port (``fami_pose_torch/engine/streaming.py``)
against the port's own batch protocol and against the JAX stream
(``fami_pose_tpu/engine/streaming.py``), at the tiny topology of
``tests/test_streaming.py``: ``TINY_EXTRA``, 8 feature channels, 4 offset
groups, B = 2 streams of 64x64 frames, DISTANCE 3, f32 on the CPU, the
same flax variables (non-trivial BatchNorm state) on both sides, bridged
with ``models/bridge.py::state_dict_from_flax``. The DCN window is D = 2 on
both sides (the JAX model's windowed DCN, not its Pallas kernel).

Tolerances:
  * ``features`` then ``head_eval`` against ``forward``, a merged state's
    untouched streams, the window order, ``box_iou_cs``, the re-prime mask
    and locked boxes: exact.
  * The port's stream against the port's batch protocol, paired against
    batched flip, a re-primed stream against a never re-primed one: 1e-5
    of the heatmaps' largest magnitude (:func:`_same`). The streamed
    features come from backbone calls of other batch sizes than the batch
    protocol's (B or T * B frames against 5 * B), and a CPU convolution may
    sum in another order at another batch size.
  * The port's stream against the JAX stream: ``tests/test_torch_fami_pose.py``'s
    tolerance, 2e-4 relative + 2e-4 of the largest magnitude (the head's
    activations grow to ~1e3 on random weights; XLA and torch sum in other
    orders), and 2e-4 + 2e-4 relative for the backbone heatmaps.
  * The streaming demo writes one finite pose per box per frame.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.engine import streaming as jax_streaming
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.hrnet import TINY_EXTRA
from fami_pose_torch.engine import streaming
from fami_pose_torch.engine.steps import make_eval_step
from fami_pose_torch.models.bridge import state_dict_from_flax
from fami_pose_torch.models.fami_pose import FAMIPose
from torch_port_helpers import nchw, nhwc, random_variables

B, H, W = 2, 64, 64
DISTANCE = 3
NUM_SUP = 2 * (DISTANCE - 1)
SPAN = DISTANCE - 1
JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4, dcn_max_offset=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tests run many small ops: one intra-op thread runs them as fast
    as eight alone, and far faster when the suite's workers share the
    cores. Restored for the worker's next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    m = JaxFAMIPose(**JAX_KW)
    kf = jnp.zeros((1, H, W, 3))
    sup = jnp.zeros((1, H, W, 3 * NUM_SUP))
    return random_variables(lambda k: m.init(k, kf, sup, train=False), seed=7)


@pytest.fixture(scope="module")
def model(variables):
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=NUM_SUP,
                 feat_channels=8, feat_hw=(16, 16), dcn_offset_groups=4,
                 dcn_max_offset=2, warp_max_shift=26)
    m.load_state_dict(state_dict_from_flax(variables))
    return m.eval()


def _frames(seed, n):
    """n consecutive NHWC frames of each stream: (n, B, H, W, 3) numpy."""
    return np.random.RandomState(seed).rand(n, B, H, W, 3).astype(np.float32)


def _nchw_frames(frames):
    return torch.stack([nchw(f) for f in frames])  # (n, B, 3, H, W)


def _same(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(ref).max())))


def _stream(model, frames, flip_test=False, flip_batched=False):
    """Feed ``frames`` ((n, B, 3, H, W)) through a stream primed with frame
    0 and ``SPAN`` more copies of the last frame; returns {key frame:
    (final_hm, kf_bb_hm)} for every key frame of the clip."""
    pred = streaming.StreamingPosePredictor(
        model, distance=DISTANCE, flip_test=flip_test,
        flip_batched=flip_batched)
    pred.prime(frames[0])
    n = frames.shape[0]
    out = {}
    for t in range(n + SPAN):
        hm, kf_bb = pred(frames[min(t, n - 1)])
        if t >= SPAN:
            out[t - SPAN] = (hm.numpy(), kf_bb.numpy())
    return out


def _window(frames, t):
    """The batch protocol's (kf, sup) of key frame t: supporting frames
    ``t - 2, t - 1, t + 1, t + 2`` clamped to the clip (as
    ``PosePredictor.window``), stacked on the channel axis."""
    n = frames.shape[0]
    sup_t = [t - d for d in range(SPAN, 0, -1)] + [t + d
                                                    for d in range(1, DISTANCE)]
    sup = [frames[min(max(s, 0), n - 1)] for s in sup_t]
    return frames[t], torch.cat(sup, dim=1)


@pytest.mark.parametrize("distance", [1, 2, 3, 4])
def test_window_order_matches_jax(distance):
    assert streaming.window_order(distance) == \
        jax_streaming.window_order(distance)


def test_features_then_head_eval_is_forward(model):
    """The eval forward is the serving split's composition, bit for bit;
    the split refuses a module in train mode."""
    rs = np.random.RandomState(3)
    kf = torch.from_numpy(rs.randn(B, 3, H, W).astype(np.float32))
    sup = torch.from_numpy(rs.randn(B, 3 * NUM_SUP, H, W).astype(np.float32))
    with torch.no_grad():
        full_hm, full_bb = model(kf, sup)
        x = torch.cat([kf] + list(torch.split(sup, 3, dim=1)), dim=0)
        bb_hm, feat = model.features(x)
        split_hm, split_bb = model.head_eval(feat, bb_hm[:B])
        # and the backbone and head called as the forward called them
        # before the split
        bb_ref, feats_ref = model.hrnet(x)
        head_ref = model.head(feats_ref[0], B)
    assert torch.equal(full_hm, split_hm) and torch.equal(full_bb, split_bb)
    assert torch.equal(split_hm, head_ref) and torch.equal(bb_hm, bb_ref)
    assert tuple(feat.shape) == (5 * B, 8, 16, 16)
    with pytest.raises(ValueError, match="fold"):
        model.head_eval(feat[:-1], bb_hm[:B])
    model.train()
    try:
        for call in (lambda: model.features(x),
                     lambda: model.head_eval(feat, bb_hm[:B])):
            with pytest.raises(ValueError, match="eval-only"):
                call()
    finally:
        model.eval()


@pytest.mark.parametrize("flip_test", [False, True])
def test_stream_matches_batch_protocol(model, flip_test):
    """Every key frame of a crop-locked 7-frame clip (the clamped boundary
    frames too: the primed buffer clamps to the first frame and the tail
    is fed copies of the last, as the batch protocol's windows clamp)
    against the port's eval step on that key frame's window."""
    frames = _nchw_frames(_frames(0, 7))
    got = _stream(model, frames, flip_test=flip_test)
    step = make_eval_step(model, flip_test=flip_test)
    assert sorted(got) == list(range(7))
    for t in range(7):
        ref_hm, ref_bb = step(*_window(frames, t))
        _same(got[t][0], ref_hm.numpy())
        _same(got[t][1], ref_bb.numpy())


def test_stream_matches_the_jax_stream(model, variables):
    """The port's stream and the JAX stream (one jitted step) on the same
    weights and frames: every emission of a 6-frame clip."""
    frames = _frames(1, 6)
    m = JaxFAMIPose(**JAX_KW)
    step = jax.jit(jax_streaming.make_step(m, variables, DISTANCE))
    state = jax_streaming.init_state(m, variables, jnp.asarray(frames[0]),
                                     DISTANCE)
    pred = streaming.StreamingPosePredictor(model, distance=DISTANCE)
    pred.prime(nchw(frames[0]))
    for t in range(6):
        state, (hm, kf_bb) = step(state, jnp.asarray(frames[t]))
        p_hm, p_bb = pred(nchw(frames[t]))
        assert p_hm.dtype == torch.float32 and tuple(p_hm.shape) == \
            (B, 17, 16, 16)
        np.testing.assert_allclose(nhwc(p_bb), np.asarray(kf_bb), rtol=2e-4,
                                   atol=2e-4)
        _close(nhwc(p_hm), hm)


def test_paired_flip_matches_batched_flip(model):
    frames = _nchw_frames(_frames(2, 4))
    paired = _stream(model, frames, flip_test=True)
    batched = _stream(model, frames, flip_test=True, flip_batched=True)
    for t in paired:
        _same(batched[t][0], paired[t][0])
        _same(batched[t][1], paired[t][1])


def _emissions(model, state, frames, start):
    step = streaming.make_step(model, DISTANCE)
    out = {}
    for t in range(start, frames.shape[0]):
        state, (hm, _) = step(state, frames[t])
        out[t] = hm.numpy()
    return out


def test_init_state_from_history_full_window(model):
    """Re-primed at t0 = W - 1 from the last W frames: every later emission
    equals a never re-primed stream's."""
    frames = _nchw_frames(_frames(3, 8))
    w = 2 * DISTANCE - 1
    virgin = _emissions(model, streaming.init_state(model, frames[0],
                                                    DISTANCE), frames, 0)
    t0 = w - 1
    state = streaming.init_state_from_history(model, frames[:t0 + 1],
                                              DISTANCE)
    assert state.pos == 0 and tuple(state.feats.shape[:2]) == (w, B)
    for t, hm in _emissions(model, state, frames, t0 + 1).items():
        _same(hm, virgin[t])


def test_init_state_from_history_partial_clamps_then_converges(model):
    """T = 2 < W: the missing slots clamp to the oldest frame of the
    history (slot by slot, the primed buffer holds history[max(i - 3, 0)]),
    and the emissions match the never re-primed stream once the clamped
    slots have left the window."""
    frames = _nchw_frames(_frames(4, 9))
    w = 2 * DISTANCE - 1
    virgin = _emissions(model, streaming.init_state(model, frames[0],
                                                    DISTANCE), frames, 0)
    t0, t_hist = 4, 2
    state = streaming.init_state_from_history(
        model, frames[t0 - t_hist + 1:t0 + 1], DISTANCE)
    one = streaming.init_state(model, frames[t0 - 1], DISTANCE)
    for i in range(w - t_hist + 1):  # clamped slots hold the oldest frame
        assert torch.equal(state.feats[i], one.feats[0])
    with pytest.raises(ValueError, match="history length"):
        streaming.init_state_from_history(model, frames[:w + 1], DISTANCE)
    for t, hm in _emissions(model, state, frames, t0 + 1).items():
        if t - t0 >= w - t_hist:
            _same(hm, virgin[t])


def test_box_iou_cs_matches_jax():
    rs = np.random.RandomState(5)
    c_a, c_b = rs.rand(2, 16, 2) * 300
    s_a, s_b = rs.rand(2, 16, 2) * 1.5 + 0.05
    c_b[:3] = c_a[:3]
    s_b[:3] = s_a[:3]  # identical boxes
    c_b[3] = c_a[3] + 1e4  # disjoint
    got = streaming.box_iou_cs(c_a, s_a, c_b, s_b)
    np.testing.assert_array_equal(got,
                                  jax_streaming.box_iou_cs(c_a, s_a, c_b, s_b))
    np.testing.assert_allclose(got[:3], 1.0)
    assert got[3] == 0.0


def test_merge_leaves_unmoved_streams_bitwise(model):
    """Stream 0 keeps its state through a merge, stream 1 re-primes from
    other crops: stream 0's later emissions equal a never re-primed run's
    bit for bit, stream 1's a fully re-primed run's."""
    n, t0, t_hist = 9, 4, 3
    frames = _nchw_frames(_frames(6, n))
    other = _nchw_frames(_frames(7, n))
    virgin = _emissions(model, streaming.init_state(model, frames[0],
                                                    DISTANCE), frames, 0)
    hist = other[t0 - t_hist + 1:t0 + 1]
    reprimed = _emissions(
        model, streaming.init_state_from_history(model, hist, DISTANCE),
        other, t0 + 1)
    step = streaming.make_step(model, DISTANCE)
    state = streaming.init_state(model, frames[0], DISTANCE)
    for t in range(t0 + 1):
        state, _ = step(state, frames[t])
    old_feats = state.feats.clone()
    state = streaming.merge_stream_states(
        state, streaming.init_state_from_history(model, hist, DISTANCE),
        np.array([False, True]))
    assert state.pos == 0
    # the old buffers were rotated to newest-last: frame t0 in the last slot
    w = 2 * DISTANCE - 1
    assert torch.equal(state.feats[w - 1, 0], old_feats[t0 % w, 0])
    for t in range(t0 + 1, n):
        mixed = torch.cat([frames[t, :1], other[t, 1:]], dim=0)
        state, (hm, _) = step(state, mixed)
        np.testing.assert_array_equal(hm[0].numpy(), virgin[t][0])
        np.testing.assert_array_equal(hm[1].numpy(), reprimed[t][1])


def test_maybe_reprime_matches_the_jax_policy(model, variables, monkeypatch):
    """The same box sequence through the port's and JAX's
    ``StreamingPosePredictor`` (IoU threshold 0.6): the same masks and the
    same locked boxes after every call. JAX's re-prime itself is replaced
    by a stub (its buffers are not what is compared here; the merge is
    held above), so no JAX step is compiled."""
    monkeypatch.setattr(jax_streaming, "init_state_from_history",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_streaming, "merge_stream_states",
                        lambda old, new, mask: old)
    m = JaxFAMIPose(**JAX_KW)
    jpred = jax_streaming.StreamingPosePredictor(m, variables,
                                                 distance=DISTANCE,
                                                 reprime_iou=0.6)
    ppred = streaming.StreamingPosePredictor(model, distance=DISTANCE,
                                             reprime_iou=0.6)
    frames = _nchw_frames(_frames(8, 4))
    centers0 = np.array([[50.0, 50.0], [50.0, 50.0]], np.float32)
    scales0 = np.array([[0.4, 0.4], [0.4, 0.4]], np.float32)
    jpred._state = "primed"
    jpred._lock_boxes(centers0, scales0)
    ppred.prime(frames[0], centers=centers0, scales=scales0)
    for t in range(1, 4):
        ppred(frames[t])
    sequence = [([[50.0, 50.0], [90.0, 50.0]], scales0),  # stream 1 moved
                ([[51.0, 50.0], [90.0, 50.0]], scales0),  # below threshold
                ([[80.0, 60.0], [91.0, 52.0]], scales0 * 1.5),
                ([[80.0, 60.0], [20.0, 20.0]], scales0)]
    for centers, scales in sequence:
        centers = np.asarray(centers, np.float32)
        want = jpred.maybe_reprime(centers, scales, history=None)
        got = ppred.maybe_reprime(centers, scales, history=frames[1:4])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ppred._locked_center,
                                      jpred._locked_center)
        np.testing.assert_array_equal(ppred._locked_scale,
                                      jpred._locked_scale)
        hm, _ = ppred(frames[3])
        assert torch.isfinite(hm).all()
    # the trigger off: never re-primes
    off = streaming.StreamingPosePredictor(model, distance=DISTANCE)
    off.prime(frames[0], centers=centers0, scales=scales0)
    assert not off.boxes_moved(sequence[0][0], scales0).any()
    with pytest.raises(RuntimeError, match="prime"):
        streaming.StreamingPosePredictor(model)(frames[0])


def test_demo_streaming_writes_a_pose_per_box_per_frame(tmp_path):
    """``python -m fami_pose_torch.demo --streaming --device cpu``: frames
    from image files, two boxes a frame (the second frame's differ: the
    crops stay locked at the first frame's), every frame's key frame
    emitted for each box of the first frame."""
    import cv2

    from fami_pose_torch.demo import main

    rs = np.random.RandomState(2)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    n = 4
    for i in range(n):
        img = rs.randint(0, 256, size=(40, 52, 3)).astype(np.uint8)
        cv2.imwrite(str(frames_dir / f"{i:04d}.png"), img)
    dets = [{"frame": i, "bbox": [4, 5, 30, 30], "score": 0.7}
            for i in range(n)]
    dets += [{"frame": f"{i:04d}.png", "bbox": [10, 2 + (i == 1), 20, 33]}
             for i in range(n)]
    boxes = tmp_path / "boxes.json"
    boxes.write_text(json.dumps(dets))
    out = tmp_path / "out"
    main(["--cfg", "configs/posetrack17/fami_pose.yaml",
          "--frames", str(frames_dir), "--boxes", str(boxes),
          "--out", str(out), "--device", "cpu", "--streaming",
          "MODEL.IMAGE_SIZE", "[32,32]", "MODEL.HEATMAP_SIZE", "[8,8]"])
    records = json.loads((out / "keypoints.json").read_text())
    assert [r["frame"] for r in records] == [
        f"{i:04d}.png" for i in range(n) for _ in range(2)]
    assert [r["bbox"] for r in records[:2]] == [[4.0, 5.0, 30.0, 30.0],
                                                [10.0, 2.0, 20.0, 33.0]]
    assert [r["bbox_score"] for r in records[:2]] == [0.7, 1.0]
    kp = np.asarray([r["keypoints"] for r in records])
    assert kp.shape == (2 * n, 17, 3) and np.all(np.isfinite(kp))


def test_streaming_config_matches_the_batch_predictor():
    """The demo's stream and ``PosePredictor`` build the same model from a
    config: the same window (DISTANCE 3 -> 4 supporting frames)."""
    from fami_pose_torch.config import get_cfg
    from fami_pose_torch.engine.predictor import serving_model

    cfg = get_cfg(types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", root_dir=".",
        opts=["MODEL.IMAGE_SIZE", [32, 32], "MODEL.HEATMAP_SIZE", [8, 8]]))
    m = serving_model(cfg, device="cpu", seed=3)
    assert not m.training and m.num_sup == 2 * (int(cfg.DISTANCE) - 1)
    assert streaming.window_order(int(cfg.DISTANCE)) == [2, 0, 1, 3, 4]
