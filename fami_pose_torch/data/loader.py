"""Input preparation on the device and the host-side batch loader
(``fami_pose_tpu/data/loader.py``).

Eval: host-cropped uint8 batches are normalized on the device
(:func:`prepare_eval_inputs`); with raw frames or raw person windows
(``TPU.DEVICE_CROP``, the serving predictor) the person-box crop runs on the
device too (:func:`prepare_eval_inputs_device_crop`,
``ops.warp.crop_and_warp``): frames stay uint8 until the crop samples them,
and no ``cv2`` is needed on that path.

Training: host threads run ``dataset[i]`` and stack uint8 crops
(:func:`collate`, :class:`DataLoader`); normalization and Gaussian target
stamping run on the device, once per batch (:func:`prepare_train_batch`);
with raw person windows (``TPU.DEVICE_CROP``) the augmented crop runs on
the device too (:func:`prepare_train_batch_device_crop`).

Over several processes (``parallel/mesh.py``) every rank computes the same
global order of each epoch and loads only its contiguous slice of every
global batch (:class:`DataLoader`).
"""

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fami_pose_torch.ops.heatmap import generate_heatmaps
from fami_pose_torch.parallel.mesh import data_split
from fami_pose_torch.parallel.mesh import process_count as _process_count
from fami_pose_torch.parallel.mesh import process_index as _process_index
from fami_pose_torch.ops.warp import crop_and_warp

from .video_dataset import IMAGENET_MEAN, IMAGENET_STD


def normalize(x):
    """(N, 3k, H, W) pixel values in [0, 255] -> ImageNet-normalized f32."""
    c = x.shape[1] // 3
    mean = torch.as_tensor(np.tile(IMAGENET_MEAN, c), device=x.device)
    std = torch.as_tensor(np.tile(IMAGENET_STD, c), device=x.device)
    x = x.to(torch.float32) / 255.0
    return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def prepare_eval_inputs(kf_u8, sup_u8, device=None):
    """Host-cropped uint8 batches as the datasets give them, (B, H, W, 3) and
    (B, H, W, 3N) arrays or tensors, -> normalized float32 (B, 3, H, W) and
    (B, 3N, H, W) on ``device`` (default: where ``kf_u8`` lies)."""
    def on_device(a):
        t = torch.as_tensor(a)
        return t.to(device=device if device is not None else t.device,
                    non_blocking=True).permute(0, 3, 1, 2)

    return normalize(on_device(kf_u8)), normalize(on_device(sup_u8))


def prepare_eval_inputs_device_crop(kf_raw, sup_raw, center, scale, rotation,
                                    image_size):
    """Crop + normalize one key frame and its stacked supporting frames.

    Args:
      kf_raw: (B, 3, H, W) frames; sup_raw: (B, 3N, H, W), N frames stacked
        on the channel axis like the model's input.
      center, scale: (B, 2) box parameters; rotation: (B,) degrees.
      image_size: (w, h) of the crop, as in ``MODEL.IMAGE_SIZE``.

    Returns:
      (kf, sup): (B, 3, h, w) and (B, 3N, h, w) float32.
    """
    out_hw = (int(image_size[1]), int(image_size[0]))
    b, c3 = sup_raw.shape[:2]
    n = c3 // 3
    kf = crop_and_warp(kf_raw, center, scale, rotation, out_hw)
    sup = crop_and_warp(
        sup_raw.reshape(b * n, 3, *sup_raw.shape[2:]),
        center.repeat_interleave(n, 0), scale.repeat_interleave(n, 0),
        rotation.repeat_interleave(n, 0), out_hw,
    ).reshape(b, c3, *out_hw)
    return normalize(kf), normalize(sup)


def prepare_train_batch(kf_u8, sup_u8, joints, joints_vis, sigma, image_size,
                        heatmap_size, device=None):
    """uint8 crops + joints -> normalized inputs + heatmap targets, on
    ``device`` (default: where ``kf_u8`` lies).

    Args:
      kf_u8: (B, H, W, 3) uint8 crops as the dataset gives them (arrays or
        tensors); sup_u8: (B, H, W, 3N).
      joints: (B, J, 2) crop pixels; joints_vis: (B, J).
      image_size, heatmap_size: (w, h).

    Returns a dict: ``kf`` (B, 3, H, W) and ``sup`` (B, 3N, H, W) float32,
    ``target`` (B, J, h, w) and ``target_weight`` (B, J).
    """
    def on_device(a, dtype=None):
        t = torch.as_tensor(a)
        return t.to(device=device if device is not None else t.device,
                    dtype=dtype, non_blocking=True)

    kf = on_device(kf_u8).permute(0, 3, 1, 2)
    sup = on_device(sup_u8).permute(0, 3, 1, 2)
    target, weight = generate_heatmaps(
        on_device(joints, torch.float32), on_device(joints_vis, torch.float32),
        sigma, image_size, heatmap_size,
    )
    return {"kf": normalize(kf), "sup": normalize(sup), "target": target,
            "target_weight": weight[..., 0]}


def prepare_train_batch_device_crop(kf_raw, sup_raw, crop_center, scale,
                                    rotation, joints, joints_vis, sigma,
                                    image_size, heatmap_size, device=None):
    """The train batch of raw person windows (``TPU.DEVICE_CROP``): the
    augmented crop (scale, rotation, the window's own centre) runs on the
    device (``ops.warp.crop_and_warp``, the reference's per-sample
    ``cv2.warpAffine``), then normalization and heatmap targets as in
    :func:`prepare_train_batch`.

    Args:
      kf_raw: (B, Hc, Wc, 3) uint8 windows as the datasets give them (arrays
        or tensors); sup_raw: (B, Hc, Wc, 3N).
      crop_center, scale: (B, 2) in window pixels and boxes of 200 px;
        rotation: (B,) degrees.
      joints: (B, J, 2) crop pixels; joints_vis: (B, J).
      image_size, heatmap_size: (w, h).

    Returns the dict of :func:`prepare_train_batch` on ``device`` (default:
    where ``kf_raw`` lies), the inputs in channels-last memory order as
    :func:`prepare_train_batch`'s permuted uint8 batch is: convolution
    libraries keep an input's memory order through the network, and on the
    card cuDNN's NCHW kernels made a B=8 W48 train step ~35% longer in
    device time than its channels-last ones.
    """
    def on_device(a, dtype=None):
        t = torch.as_tensor(a)
        return t.to(device=device if device is not None else t.device,
                    dtype=dtype, non_blocking=True)

    kf, sup = prepare_eval_inputs_device_crop(
        on_device(kf_raw).permute(0, 3, 1, 2),
        on_device(sup_raw).permute(0, 3, 1, 2),
        on_device(crop_center, torch.float32), on_device(scale, torch.float32),
        on_device(rotation, torch.float32), image_size,
    )
    target, weight = generate_heatmaps(
        on_device(joints, torch.float32), on_device(joints_vis, torch.float32),
        sigma, image_size, heatmap_size,
    )
    return {"kf": kf.contiguous(memory_format=torch.channels_last),
            "sup": sup.contiguous(memory_format=torch.channels_last),
            "target": target, "target_weight": weight[..., 0]}


def reverse_transforms(batch_imgs):
    """Normalized float images (N, 3k, H, W), arrays or tensors -> uint8
    pixels of the same layout (the reference's ``reverse_transforms``,
    ``datasets/transforms/build.py:31-40``)."""
    x = torch.as_tensor(batch_imgs).detach().to("cpu", torch.float32).numpy()
    c = x.shape[1] // 3
    mean = np.tile(IMAGENET_MEAN, c).reshape(1, -1, 1, 1)
    std = np.tile(IMAGENET_STD, c).reshape(1, -1, 1, 1)
    x = (x * std + mean) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def collate(samples):
    """Stack host samples into a batch of numpy arrays (+ the path list)."""
    out = {}
    for k in ("kf", "sup", "joints", "joints_vis", "center", "scale",
              "rotation", "score"):
        out[k] = np.stack([s[k] for s in samples])
    out["image_path"] = [s["image_path"] for s in samples]
    if "crop_center" in samples[0]:  # TPU.DEVICE_CROP: raw person windows
        out["crop_center"] = np.stack([s["crop_center"] for s in samples])
    return out


class DataLoader:
    """Minimal epoch iterator: seeded shuffling, threaded map, bounded
    prefetch. A dataset is any object with ``__len__`` and ``__getitem__``
    that gives the sample dict :func:`collate` reads.

    ``drop_last`` mirrors torch; when False the last partial batch is padded
    by repeating its last sample and ``batch["valid"]`` counts the real rows.
    The order of epoch e is ``RandomState(seed + e)``'s shuffle, as in the
    JAX package's loader.

    ``batch_size`` is the global batch. Over ``process_count`` processes
    (default: the ranks of the process group) every process computes the
    same global order and loads only its contiguous slice of each batch,
    rows ``[p * local, (p + 1) * local)`` for process ``p``
    (``local_batch_size`` rows); ``valid`` still counts the global batch's
    real rows, and when the dataset has an index (``data``, as the
    PoseTrack and JHMDB datasets do) each batch carries ``global_meta``
    (``center``, ``scale``, ``score`` and ``image_path`` of every global
    row, read from the index without image IO) for the eval loop. A global
    batch that the processes cannot split evenly raises ``ValueError``.
    """

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=4,
                 drop_last=False, seed=0, prefetch=2, process_index=None,
                 process_count=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.process_count = (_process_count() if process_count is None
                              else int(process_count))
        self.process_index = (_process_index() if process_index is None
                              else int(process_index))
        if self.batch_size % self.process_count:
            raise ValueError(
                f"global batch {self.batch_size} not divisible by "
                f"{self.process_count} processes")
        self.local_batch_size = self.batch_size // self.process_count

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        batches = []
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    continue
                pad = np.full(self.batch_size - len(idx), idx[-1])
                batches.append((np.concatenate([idx, pad]), len(idx)))
            else:
                batches.append((idx, len(idx)))
        return batches

    def _load_batch(self, idx, valid):
        lo, n = self.process_index * self.local_batch_size, \
            self.local_batch_size
        batch = collate([self.dataset[int(i)] for i in idx[lo:lo + n]])
        batch["valid"] = valid
        db = getattr(self.dataset, "data", None)
        if self.process_count == 1 or db is None:
            return batch
        # eval applies no augmentation, so the index's center, scale and
        # score are the samples' own
        batch["global_meta"] = {
            "center": np.stack([db[int(i)]["center"] for i in idx]).astype(
                np.float32),
            "scale": np.stack([db[int(i)]["scale"] for i in idx]).astype(
                np.float32),
            "score": np.asarray([db[int(i)].get("score", 1.0) for i in idx],
                                np.float32),
            "image_path": [db[int(i)]["image"] for i in idx],
        }
        return batch

    def __iter__(self):
        """Yield the epoch's batches in order, loaded by ``num_workers``
        threads at most ``num_workers + prefetch`` batches ahead."""
        batches = self._index_batches()
        if self.num_workers <= 1:
            for idx, valid in batches:
                yield self._load_batch(idx, valid)
            self.epoch += 1
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers + self.prefetch
            it = iter(batches)
            futures = deque(pool.submit(self._load_batch, idx, valid)
                            for idx, valid in itertools.islice(it, window))
            while futures:
                batch = futures.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(pool.submit(self._load_batch, *nxt))
                yield batch
        self.epoch += 1


def build_train_loader(cfg, dataset, mesh=None, **kwargs):
    """The training loader of a config: a global batch of
    ``TRAIN.BATCH_SIZE_PER_GPU`` samples a slice of the data axis of
    ``mesh`` (default: one slice a rank of the process group), this rank's
    slice loaded, shuffled, last partial batch dropped."""
    n_dev, index = data_split(mesh)
    return DataLoader(
        dataset,
        batch_size=int(cfg.TRAIN.BATCH_SIZE_PER_GPU) * n_dev,
        shuffle=bool(cfg.TRAIN.SHUFFLE),
        num_workers=int(cfg.WORKERS),
        drop_last=True,
        seed=int(cfg.SEED),
        process_index=index,
        process_count=n_dev,
        **kwargs,
    )


def build_eval_loader(cfg, dataset, phase="validate", mesh=None, **kwargs):
    """The eval loader of a config: a global batch of ``VAL`` /
    ``TEST.BATCH_SIZE_PER_GPU`` samples a slice of the data axis of
    ``mesh`` (default: one slice a rank of the process group), this rank's
    slice loaded, in dataset order, the last batch padded
    (``batch["valid"]`` counts its real rows)."""
    sub = cfg.VAL if phase == "validate" else cfg.TEST
    n_dev, index = data_split(mesh)
    return DataLoader(
        dataset,
        batch_size=int(sub.BATCH_SIZE_PER_GPU) * n_dev,
        shuffle=False,
        num_workers=int(cfg.WORKERS),
        drop_last=False,
        process_index=index,
        process_count=n_dev,
        **kwargs,
    )
