"""Streaming serving: per-frame backbone features cached across windows; the
port of ``fami_pose_tpu/engine/streaming.py``.

The reference's eval protocol (``Alignment_V15.py:113-122`` +
``PoseTrack_Alignment.py:311-359``) runs the full backbone on all
``1 + num_sup`` frames of every clip. In video serving, consecutive key
frames share ``num_sup`` of those frames: with DISTANCE=3 each video frame
appears in up to 5 sliding windows, so per key frame the batch protocol
runs 5 backbone passes where steady-state streaming needs one.

This module serves ``B`` parallel video streams that way: a rolling
on-device feature buffer spans the temporal window, and one step per frame
advance

  1. runs the backbone once on the ``B`` new frames
     (:meth:`FAMIPose.features`),
  2. writes them into the buffer's next slot, in place,
  3. gathers the window in the dataset's fold order and runs the alignment
     head (:meth:`FAMIPose.head_eval`) for the window's key frame.

Numerics: the head consumes cached features identical to the ones the full
forward would compute, so a steady-state streaming step equals the full
forward *when every frame of the window was cropped with the same affine*
("crop-locked" serving: the person box is held fixed while a window spans
it). The reference's batch protocol instead re-crops all 5 frames with each
key frame's box (``PoseTrack_Alignment.py:116-126``), so cross-window reuse
is exact only while the box is static; a deployed tracker re-crops (and
re-primes the stream) when the box moves materially
(:meth:`StreamingPosePredictor.maybe_reprime`). Boundary key frames (the
first and last ``distance - 1`` of a stream) also differ slightly from the
dataset's: the dataset pads missing neighbours with the key frame itself
(delta-0 padding, ``support_frame_deltas``), while the primed buffer clamps
to the first frame, as the port's ``PosePredictor`` clamps its windows to
the clip's edges. Interior key frames under a fixed crop are exact up to
the backbone's batch size: the features of ``B`` frames come from a
backbone call on ``B`` frames, where the batch protocol's come from one on
``(1 + num_sup) * B``, and a library convolution may sum in another order
at another batch size (``tests/test_torch_streaming.py`` and
``chip_smoke.py`` phase ``streaming`` state their tolerances).

Latency: the step fed frame ``t`` emits the heatmap for key frame
``t - (distance - 1)`` (the window needs ``distance - 1`` future frames,
exactly like the offline protocol).

A model calibrated for int8 (``models.quant.calibrate``; ``TPU.INT8_EVAL``)
streams int8: ``features`` and ``head_eval`` run its int8 convs with the
scales fixed at calibration, so calibrate first, then prime the stream, as
the JAX package's ``tools/bench_streaming_flip.py`` does.

The buffers are written in place (one slot a step, ``buf[pos].copy_``), so
a step mutates the :class:`StreamState` it is given and returns it. Every
function here runs under ``torch.inference_mode``.

Over a mesh whose data axis is larger than 1 (``mesh=``,
``parallel/mesh.py``), the streams are served data-parallel, as the JAX
package's ``stream_shardings`` shard them: the functions take the global
frames ``(B, ...)``, each rank keeps and serves its data index's contiguous
``B / n`` streams with no collective inside the step, and the step's
outputs are gathered by rows (one rank of each data index), so that every
rank returns the global ``(B, J, h, w)`` heatmaps. The ranks of a
``model`` axis serve the same streams. A rank's :class:`StreamState` holds
its own streams only; :meth:`StreamingPosePredictor.maybe_reprime` takes
the global boxes and history and re-primes the moved streams among the
rank's own.
"""

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS
from fami_pose_torch.ops.pose import flip_back
from fami_pose_torch.parallel.mesh import all_gather_rows, local_rows


@dataclasses.dataclass
class StreamState:
    """Circular window buffers for B parallel streams.

    ``pos`` is the slot the next step writes; frame ``t - k`` lives at slot
    ``(pos - 1 - k) mod W`` after the step that consumed frame ``t``. A
    circular buffer writes one slot a step where a shifted one would
    rewrite the whole buffer."""

    feats: torch.Tensor  # (W, B, C, h, w) backbone features
    bb_hms: torch.Tensor  # (W, B, J, h, w) backbone heatmaps
    pos: int = 0  # next write slot
    feats_f: Optional[torch.Tensor] = None  # mirrored frames' (flip-test)


def window_order(distance: int) -> List[int]:
    """Buffer-slot read order ``[key, sup...]`` matching the dataset fold:
    previous supporting frames farthest first, then the next ones nearest
    first (``data/posetrack.support_frame_deltas``)."""
    k = distance - 1
    prev = [k - d for d in range(distance - 1, 0, -1)]
    nxt = [k + d for d in range(1, distance)]
    return [k] + prev + nxt


def _mirror(frames):
    return torch.flip(frames, dims=(3,))


@torch.inference_mode()
def init_state(model, first_frames, distance: int,
               flip_test: bool = False, mesh=None) -> StreamState:
    """Prime the rolling buffer by replicating the first frames' features
    (``(B, 3, H, W)``) into every slot (the clamp-to-first boundary; see the
    module docstring). Over ``mesh``, this rank's streams of the global
    frames."""
    first_frames = local_rows(first_frames, mesh)
    w = 2 * distance - 1
    bb_hm, feat = model.features(first_frames)

    def tile(t):
        return t.unsqueeze(0).repeat(w, *([1] * t.dim()))

    state = StreamState(feats=tile(feat), bb_hms=tile(bb_hm))
    if flip_test:
        state.feats_f = tile(model.features(_mirror(first_frames))[1])
    return state


@torch.inference_mode()
def init_state_from_history(model, history, distance: int,
                            flip_test: bool = False,
                            mesh=None) -> StreamState:
    """Prime the rolling buffer from real frame history: the re-prime path a
    deployed tracker takes when a stream's crop box moves materially (the
    crop-locked condition breaks and features cached under the old crop are
    stale).

    ``history`` is ``(T, B, 3, H, W)``, oldest first, ``1 <= T <= 2 *
    distance - 1``: the last ``T`` frames re-cropped under the new box.
    Slots older than the history clamp to the oldest frame (the convention
    :func:`init_state` applies with ``T = 1``). The result is the state a
    stream fed those frames from scratch would hold (eval-mode BatchNorm is
    per sample, so folding ``T`` into the batch of one backbone call
    computes the same features), so later emissions match a never re-primed
    stream as soon as the clamped slots leave the window. Over ``mesh``,
    this rank's streams (columns) of the global history."""
    history = local_rows(history.transpose(0, 1), mesh).transpose(0, 1)
    w = 2 * distance - 1
    t_n, b = int(history.shape[0]), int(history.shape[1])
    if not 1 <= t_n <= w:
        raise ValueError(f"history length {t_n} not in [1, {w}]")
    flat = history.reshape(t_n * b, *history.shape[2:])
    bb_hm, feat = model.features(flat)
    # slot i holds history[max(i - (w - T), 0)]; pos = 0, so the next write
    # overwrites the oldest slot: frame t - k sits at slot w - 1 - k, the
    # newest-last layout the step reads
    idx = (torch.arange(w) - (w - t_n)).clamp(min=0).to(feat.device)

    def slots(t):
        return t.reshape(t_n, b, *t.shape[1:]).index_select(0, idx)

    state = StreamState(feats=slots(feat), bb_hms=slots(bb_hm))
    if flip_test:
        state.feats_f = slots(model.features(_mirror(flat))[1])
    return state


def box_iou_cs(center_a, scale_a, center_b, scale_b,
               pixel_std: float = 200.0) -> np.ndarray:
    """Per-stream IoU between two (center, scale)-parameterised boxes.

    Host side (tracker boxes live on the host). Centers (B, 2), scales
    (B, 2) in the dataset's scale * pixel_std convention (``utils/bbox``)."""
    ca, sa = np.asarray(center_a, np.float64), np.asarray(scale_a, np.float64)
    cb, sb = np.asarray(center_b, np.float64), np.asarray(scale_b, np.float64)
    wa, wb = sa * pixel_std, sb * pixel_std  # (B, 2) box w/h
    lo = np.maximum(ca - wa / 2, cb - wb / 2)
    hi = np.minimum(ca + wa / 2, cb + wb / 2)
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
    union = np.prod(wa, axis=-1) + np.prod(wb, axis=-1) - inter
    return inter / np.maximum(union, 1e-12)


@torch.inference_mode()
def merge_stream_states(old: StreamState, new: StreamState,
                        mask) -> StreamState:
    """Per-stream select between an ongoing state and a freshly (re-)primed
    one: streams where ``mask`` is True take ``new``'s buffers, the rest
    keep ``old``'s.

    The two index their circular buffers differently (``new`` from
    :func:`init_state_from_history` is newest-last with ``pos = 0``), so the
    old buffers are first rotated into that layout (frame ``t - k`` moves
    from slot ``(old.pos - 1 - k) mod W`` to slot ``W - 1 - k``) and the
    merged state restarts at ``pos = 0``. The selection copies values, so
    the streams that keep their state keep it bit for bit."""
    w = int(old.feats.shape[0])
    shift = (w - int(old.pos)) % w
    m = torch.as_tensor(np.asarray(mask, dtype=bool),
                        device=old.feats.device).reshape(1, -1, 1, 1, 1)

    def sel(new_buf, old_buf):
        return torch.where(m, new_buf, torch.roll(old_buf, shift, dims=0))

    return StreamState(
        feats=sel(new.feats, old.feats),
        bb_hms=sel(new.bb_hms, old.bb_hms),
        pos=0,
        feats_f=(sel(new.feats_f, old.feats_f)
                 if old.feats_f is not None else None),
    )


def make_step(model, distance: int, flip_test: bool = False,
              flip_pairs=COCO_FLIP_PAIRS, flip_batched: bool = False,
              mesh=None):
    """Build the streaming step.

    ``step(state, frames) -> (state, (final_hm, kf_bb_hm))``: ``frames`` is
    the next frame of each stream, ``(B, 3, H, W)``, normalised as the
    model's inputs; the outputs, (B, J, h, w) float32, belong to key frame
    ``t - (distance - 1)``. ``state`` is updated in place and returned.

    With ``flip_test`` the mirrored frames' features are cached too, the
    head runs on the mirrored window as well and the two heatmaps are
    averaged as the eval step averages them (``engine/steps.py``): two
    backbone calls of ``B`` frames and two head calls a step.
    ``flip_batched`` folds the mirrored frames into the same calls instead
    (one backbone call of ``2B`` frames and one head call of a ``2B``
    fold): the same function under eval-mode BatchNorm, fewer launches, up
    to the library convolutions' sum order at another batch size.

    Over ``mesh`` with a data axis larger than 1, ``frames`` are the global
    ``(B, 3, H, W)``, ``state`` holds this rank's streams, and the outputs
    are every rank's, gathered by rows: the global ``(B, J, h, w)``.
    """
    lat = distance - 1
    gather = mesh is not None and mesh.sharded
    w = 2 * distance - 1
    # fold order relative to the key slot: [0, -lat..-1, +1..+lat]
    rel = [i - lat for i in window_order(distance)]

    def fold(buf, key_slot):
        # slots by basic indexing (views), one concatenation: an index list
        # would be copied to the device from pageable memory, and that copy
        # waits for the stream, holding the host until the backbone is done
        return torch.cat([buf[(key_slot + r) % w] for r in rel])

    @torch.inference_mode()
    def step(state: StreamState, frames):
        if gather:
            state, (final, kf_bb) = local_step(state, local_rows(frames, mesh))
            both = all_gather_rows(torch.cat([final, kf_bb], dim=1), mesh)
            return state, tuple(both.split(final.shape[1], dim=1))
        return local_step(state, frames)

    def local_step(state: StreamState, frames):
        pos = state.pos
        key_slot = (pos - lat) % w
        b = frames.shape[0]
        if flip_test and flip_batched:
            bb_hm2, feat2 = model.features(
                torch.cat([frames, _mirror(frames)], dim=0))
            state.feats[pos].copy_(feat2[:b])
            state.feats_f[pos].copy_(feat2[b:])
            state.bb_hms[pos].copy_(bb_hm2[:b])
            kf_bb = state.bb_hms[key_slot].clone()
            # interleave to the fold of a 2B batch: [key(2B), sup1(2B), ...]
            both = torch.stack([fold(state.feats, key_slot).unflatten(0, (-1, b)),
                                fold(state.feats_f, key_slot).unflatten(0, (-1, b))],
                               dim=1)
            final2, _ = model.head_eval(both.flatten(0, 2),
                                        torch.cat([kf_bb, kf_bb], dim=0))
            final = (final2[:b] + flip_back(final2[b:], flip_pairs)) * 0.5
        else:
            bb_hm, feat = model.features(frames)
            state.feats[pos].copy_(feat)
            state.bb_hms[pos].copy_(bb_hm)
            kf_bb = state.bb_hms[key_slot].clone()
            final, _ = model.head_eval(fold(state.feats, key_slot), kf_bb)
            if flip_test:
                state.feats_f[pos].copy_(model.features(_mirror(frames))[1])
                final_f, _ = model.head_eval(fold(state.feats_f, key_slot),
                                             kf_bb)
                final = (final + flip_back(final_f, flip_pairs)) * 0.5
        state.pos = (pos + 1) % w
        return state, (final.to(torch.float32), kf_bb.to(torch.float32))

    return step


class StreamingPosePredictor:
    """Stateful wrapper: one object per fleet of B streams, on the device
    of ``model`` (a :class:`FAMIPose` in eval mode).

    >>> pred = StreamingPosePredictor(model, distance=3)
    >>> pred.prime(first_frames)            # frame 0 of each stream
    >>> hm, kf_bb = pred(next_frames)       # per new frame

    Crop-locked serving is exact only while the person box is static
    (module docstring); ``reprime_iou`` adds the automatic box-motion
    trigger: pass each frame's tracker boxes to :meth:`maybe_reprime`, and
    the streams whose current box's IoU against their locked crop box drops
    below the threshold are re-primed from re-cropped history, per stream
    (the other streams' buffers stay bit for bit as they were)."""

    def __init__(self, model, distance: int = 3, flip_test: bool = False,
                 flip_batched: bool = False, reprime_iou: float = 0.0,
                 mesh=None):
        if model.training:
            raise ValueError("StreamingPosePredictor serves a model in eval "
                             "mode: call .eval() first")
        self.distance = distance
        self.flip_test = flip_test
        self.reprime_iou = float(reprime_iou)  # 0 disables the trigger
        self._model = model
        self.mesh = mesh
        self._step = make_step(model, distance, flip_test=flip_test,
                               flip_batched=flip_batched, mesh=mesh)
        self._state = None
        self._locked_center = None
        self._locked_scale = None

    def prime(self, first_frames, centers=None, scales=None):
        self._state = init_state(self._model, first_frames, self.distance,
                                 flip_test=self.flip_test, mesh=self.mesh)
        self._lock_boxes(centers, scales)

    def prime_from_history(self, history, centers=None, scales=None):
        """Re-prime all streams from the last ``T <= 2 * distance - 1``
        frames (oldest first, ``(T, B, 3, H, W)``), e.g. re-cropped under
        moved boxes; see :func:`init_state_from_history`."""
        self._state = init_state_from_history(
            self._model, history, self.distance, flip_test=self.flip_test,
            mesh=self.mesh)
        self._lock_boxes(centers, scales)

    def _lock_boxes(self, centers, scales):
        if centers is not None:
            self._locked_center = np.array(centers, np.float32)
            self._locked_scale = np.array(scales, np.float32)

    def boxes_moved(self, centers, scales) -> np.ndarray:
        """Bool mask of the streams whose current box's IoU against the
        locked crop box fell below ``reprime_iou`` (all False when the
        trigger is off or no boxes were locked)."""
        if self.reprime_iou <= 0.0 or self._locked_center is None:
            return np.zeros(len(np.atleast_2d(centers)), bool)
        iou = box_iou_cs(self._locked_center, self._locked_scale, centers,
                         scales)
        return iou < self.reprime_iou

    def maybe_reprime(self, centers, scales, history) -> np.ndarray:
        """Apply the box-motion policy: re-prime exactly the streams whose
        box moved past the threshold, from ``history`` (``(T, B, 3, H,
        W)``, oldest first, frames re-cropped under the new boxes; only the
        triggered streams' columns are used). Returns the mask.

        ``history`` must hold the frames already fed (the last ``T`` step
        inputs up to and including the previous step's) re-cropped under
        the new boxes. Including the frame about to be fed would insert it
        twice and shift every later emission by one frame.

        ``centers`` / ``scales`` should be the tracker box at the emission
        horizon, the key frame about to be emitted (the frame fed
        ``distance - 1`` steps ago), not the newest frame's box. The batch
        protocol crops every window frame under the key frame's box;
        re-priming under the newest box pins each emission ``distance - 1``
        frames behind its crop, an offset that grows with the re-prime
        rate.

        Over a mesh the boxes, the history and the returned mask are the
        global ones; each rank re-primes the moved streams among its own
        columns."""
        mask = self.boxes_moved(centers, scales)
        local = local_rows(mask, self.mesh)
        if local.any():
            new = init_state_from_history(self._model, history,
                                          self.distance,
                                          flip_test=self.flip_test,
                                          mesh=self.mesh)
            self._state = merge_stream_states(self._state, new, local)
        if mask.any():  # the locked boxes are the global ones on every rank
            self._locked_center[mask] = np.asarray(centers, np.float32)[mask]
            self._locked_scale[mask] = np.asarray(scales, np.float32)[mask]
        return mask

    def __call__(self, frames):
        if self._state is None:
            raise RuntimeError("call prime(first_frames) first")
        self._state, out = self._step(self._state, frames)
        return out
