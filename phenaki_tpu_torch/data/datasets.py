"""Datasets and the loader (counterpart of phenaki_tpu/data/datasets.py).

`ImageDataset` and `VideoDataset` are `torch.utils.data.Dataset`s whose
items are channels-last numpy float32 in [0, 1], (H, W, 3) and
(frames, H, W, c), with the values the TPU package's give. `DataLoader` is
torch's, with the string-aware collate (`collate_tensors_and_strings`: arrays
and tensors stack, caption strings stay lists) and a seeded shuffle, in place
of the TPU package's threaded loader; `cycle` repeats it forever, and
`repeat=True` does so within one iteration, its workers prefetching across
epochs.
"""

from __future__ import annotations

import random
from functools import partial
from pathlib import Path
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from phenaki_tpu_torch.data import native
from phenaki_tpu_torch.data.codecs import gif_to_tensor, video_to_tensor


def identity(t, *args, **kwargs):
    return t


def pair(val):
    return val if isinstance(val, tuple) else (val, val)


def cast_num_frames(t: np.ndarray, *, frames: int) -> np.ndarray:
    """Zero-pad or truncate (frames, H, W, c) to `frames` frames."""
    f = t.shape[0]
    if f == frames:
        return t
    if f > frames:
        return t[:frames]
    return np.concatenate([t, np.zeros((frames - f, *t.shape[1:]), t.dtype)], axis=0)


def _resize_min_side(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    """Scale so that the image covers `size` (H, W): torchvision's
    `Resize(int)` semantics, the short side to the target."""
    th, tw = size
    w, h = img.size
    scale = max(th / h, tw / w)
    return img.resize((max(int(round(w * scale)), tw), max(int(round(h * scale)), th)))


def _center_crop(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    th, tw = size
    w, h = img.size
    left, top = (w - tw) // 2, (h - th) // 2
    return img.crop((left, top, left + tw, top + th))


class _ImageTransform:
    """Resize -> random horizontal flip (p = 0.5, Python's `random`) ->
    centre crop, on PIL images."""

    def __init__(self, image_size, horizontal_flip: bool = False):
        self.size = pair(image_size)
        self.horizontal_flip = horizontal_flip

    def __call__(self, img: Image.Image) -> Image.Image:
        img = _resize_min_side(img, self.size)
        if self.horizontal_flip and random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _center_crop(img, self.size)


def _glob(folder: str, exts: Sequence[str]) -> List[Path]:
    return sorted(p for ext in exts for p in Path(folder).glob(f"**/*.{ext}"))


class ImageDataset(torch.utils.data.Dataset):
    """Every jpg/jpeg/png under `folder` (recursively, sorted) -> (H, W, 3)
    float32 in [0, 1] at `image_size`."""

    def __init__(self, folder: str, image_size, exts: Sequence[str] = ("jpg", "jpeg", "png"),
                 horizontal_flip: bool = True):
        self.folder = folder
        self.image_size = pair(image_size)
        self.paths = _glob(folder, exts)
        print(f"{len(self.paths)} training samples found at {folder}")
        self.transform = _ImageTransform(image_size, horizontal_flip=horizontal_flip)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index) -> np.ndarray:
        img = Image.open(self.paths[index])
        if img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(self.transform(img), np.float32) / 255.0


class VideoDataset(torch.utils.data.Dataset):
    """Every gif/mp4 under `folder` (recursively, sorted) -> (frames, H, W, c)
    float32 in [0, 1]. A GIF is resized and centre cropped to `image_size`
    frame by frame; an MP4 is centre cropped. With `force_num_frames` every
    item has `num_frames` frames (`cast_num_frames`). RGB GIFs with a fixed
    frame count go through the native loader when its library loads (decode,
    resize, crop, flip and cast in one pass), else through PIL."""

    def __init__(self, folder: str, image_size, channels: int = 3, num_frames: int = 17,
                 horizontal_flip: bool = False, force_num_frames: bool = True,
                 exts: Sequence[str] = ("gif", "mp4")):
        self.folder = folder
        self.image_size = pair(image_size)
        self.channels = channels
        self.num_frames = num_frames
        self.force_num_frames = force_num_frames
        self.horizontal_flip = horizontal_flip
        self.paths = _glob(folder, exts)
        self.transform = _ImageTransform(image_size, horizontal_flip=horizontal_flip)
        self.gif_to_tensor = partial(gif_to_tensor, channels=channels, transform=self.transform)
        self.mp4_to_tensor = partial(video_to_tensor, crop_size=self.image_size)
        self.cast_num_frames_fn = (partial(cast_num_frames, frames=num_frames) if force_num_frames
                                   else identity)

    def native_fast_path(self) -> bool:
        """Whether a GIF item takes the native loader."""
        return self.channels == 3 and self.force_num_frames and native.available()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index) -> np.ndarray:
        path = self.paths[index]
        if path.suffix == ".gif":
            if self.native_fast_path():
                flip = np.asarray([self.horizontal_flip and random.random() < 0.5], np.uint8)
                return native.load_gif_batch([str(path)], num_frames=self.num_frames,
                                             height=self.image_size[0], width=self.image_size[1],
                                             hflip=flip)[0]
            video = self.gif_to_tensor(str(path))
        elif path.suffix == ".mp4":
            video = self.mp4_to_tensor(str(path))
        else:
            raise ValueError(f"unknown extension {path.suffix}")
        return self.cast_num_frames_fn(video)


def _stack(field: Sequence[Any]):
    if isinstance(field[0], np.ndarray):
        return np.stack(field, axis=0)
    if isinstance(field[0], torch.Tensor):
        return torch.stack(list(field), dim=0)
    if isinstance(field[0], str):
        return list(field)
    raise ValueError("detected invalid type being passed from dataset")


def collate_tensors_and_strings(data: List[Any]) -> Tuple:
    """A batch of items -> a tuple of fields: numpy arrays and tensors
    stacked on a new first axis, strings kept as a list. An item that is one
    array or tensor gives a 1-tuple."""
    if isinstance(data[0], (np.ndarray, torch.Tensor)):
        return (_stack(data),)
    return tuple(_stack(field) for field in zip(*data))


class _ShardedEpochs(torch.utils.data.Sampler):
    """Batches of indices of one shard, epoch after epoch: each epoch a
    permutation of 0..n-1 shuffled by one `random.Random(seed)` (or
    unshuffled), its ragged tail of n % num_shards dropped, every
    num_shards-th index from `shard_id` on; the last partial batch dropped
    under `drop_last`. The same indices as the TPU package's loader
    (`phenaki_tpu/data/datasets.py`, `_epoch_indices`). With `repeat` one
    iteration never ends; else it is one epoch."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int,
                 num_shards: int = 1, shard_id: int = 0, repeat: bool = False):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} is not in [0, {num_shards})")
        per_shard = n // num_shards
        if repeat and drop_last and per_shard < batch_size:
            raise ValueError(f"{per_shard} items a shard make no batch of {batch_size}")
        self.n, self.batch_size, self.shuffle, self.drop_last = n, batch_size, shuffle, drop_last
        self.num_shards, self.shard_id, self.repeat = num_shards, shard_id, repeat
        self.per_shard = per_shard
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        if self.repeat:
            raise TypeError("a repeating loader has no length")
        full, part = divmod(self.per_shard, self.batch_size)
        return full + (1 if part and not self.drop_last else 0)

    def _epoch(self) -> List[int]:
        idx = list(range(self.n))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_id: self.per_shard * self.num_shards: self.num_shards]
        return idx

    def __iter__(self):
        while True:
            order = self._epoch()
            for i in range(0, len(order), self.batch_size):
                batch = order[i: i + self.batch_size]
                if len(batch) == self.batch_size or not self.drop_last:
                    yield batch
            if not self.repeat:
                return


class DataLoader(torch.utils.data.DataLoader):
    """torch's DataLoader with the string-aware collate, the TPU package's
    seeded order and the last partial batch dropped, as the TPU package's
    loader does by default: each epoch `random.Random(seed)` shuffles the
    indices. `num_shards` and `shard_id` give one process its shard, the
    TPU package's (`datasets.py:208-245`): every shard shuffles the same
    permutation, drops its ragged tail and takes every num_shards-th index
    from shard_id on, so the shards cover the data with no overlap and
    batch k of shard r holds rows r, r + num_shards, ... of the global batch
    k of num_shards * batch_size rows. `repeat` makes one iteration run
    epoch after epoch without end, so that worker processes
    (`num_workers`) prefetch across an epoch's end, as the TPU package's
    prefetch thread does. Other keyword arguments (`num_workers`,
    `prefetch_factor`, `pin_memory`, ...) go to torch's."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, collate_fn: Callable = collate_tensors_and_strings,
                 repeat: bool = False, num_shards: int = 1, shard_id: int = 0, **kwargs):
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        kwargs["batch_sampler"] = _ShardedEpochs(len(dataset), batch_size, shuffle, drop_last, seed,
                                                 num_shards, shard_id, repeat)
        super().__init__(dataset, collate_fn=collate_fn, **kwargs)


def cycle(dl):
    """Repeat a loader forever."""
    while True:
        yield from dl


def random_split(dataset, valid_frac: float, seed: int = 42):
    """A deterministic (train, valid) split: the indices shuffled by
    Python's `random.Random(seed)`, the last `int(valid_frac * n)` valid;
    the same split as the TPU package's for the same seed."""
    n = len(dataset)
    train_size = n - int(valid_frac * n)
    indices = list(range(n))
    random.Random(seed).shuffle(indices)
    return (torch.utils.data.Subset(dataset, indices[:train_size]),
            torch.utils.data.Subset(dataset, indices[train_size:]))
