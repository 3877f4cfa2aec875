"""Video codecs: GIF <-> array (the native C++ codec, else PIL), MP4 <->
array (cv2); counterpart of phenaki_tpu/data/codecs.py.

Arrays are channels-last numpy float32 in [0, 1], (frames, H, W, c), the
layout the models take. A torch tensor is accepted wherever an array is
written (it is moved to the host first).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

from phenaki_tpu_torch.data import native

CHANNELS_TO_MODE = {1: "L", 3: "RGB", 4: "RGBA"}


def _host_array(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):  # a torch tensor, possibly on the card or in bf16
        tensor = tensor.detach().float().cpu().numpy()
    return np.asarray(tensor)


def seek_all_images(img: Image.Image, channels: int = 3):
    """Every frame of a (possibly animated) PIL image, in `channels`' mode."""
    mode = CHANNELS_TO_MODE[channels]
    i = 0
    while True:
        try:
            img.seek(i)
            yield img.convert(mode)
        except EOFError:
            break
        i += 1


def video_tensor_to_gif(tensor, path: str, duration: int = 120, loop: int = 0,
                        optimize: bool = True) -> None:
    """(frames, H, W, c) float in [0, 1] (values outside are clipped) ->
    animated GIF: the native encoder for RGB when the library loads, else
    PIL."""
    frames = np.clip(_host_array(tensor) * 255.0, 0, 255).astype(np.uint8)
    if frames.shape[-1] == 3 and native.available():
        native.gif_encode(path, frames, delay_ms=duration, loop=loop)
        return
    images = [Image.fromarray(f.squeeze(-1) if f.shape[-1] == 1 else f) for f in frames]
    first, *rest = images
    first.save(path, save_all=True, append_images=rest, duration=duration, loop=loop,
               optimize=optimize)


def gif_to_tensor(path: str, channels: int = 3, transform=None) -> np.ndarray:
    """GIF -> (frames, H, W, c) float32 in [0, 1]. With no per-frame
    `transform` (a PIL image -> PIL image function) and RGB output, the
    native codec decodes when the library loads."""
    if transform is None and channels == 3 and native.available():
        return native.gif_decode(path).astype(np.float32) / 255.0
    frames = []
    for frame in seek_all_images(Image.open(path), channels=channels):
        if transform is not None:
            frame = transform(frame)
        arr = np.asarray(frame, dtype=np.float32) / 255.0
        frames.append(arr[..., None] if arr.ndim == 2 else arr)
    return np.stack(frames, axis=0)


def crop_center(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """(H, W, c) -> its centre (cropy, cropx)."""
    y, x = img.shape[:2]
    sx = max(x // 2 - cropx // 2, 0)
    sy = max(y // 2 - cropy // 2, 0)
    return img[sy: sy + cropy, sx: sx + cropx]


def video_to_tensor(path: str, num_frames: int = -1,
                    crop_size: Optional[int | Tuple[int, int]] = None) -> np.ndarray:
    """MP4 -> (frames, H, W, c) float32 in [0, 1], RGB, each frame centre
    cropped to `crop_size` (H, W) when given; the first `num_frames` when > 0."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if crop_size is not None:
                cs = crop_size if isinstance(crop_size, tuple) else (crop_size, crop_size)
                frame = crop_center(frame, cs[1], cs[0])
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    video = np.stack(frames, axis=0).astype(np.float32) / 255.0
    return video[:num_frames] if num_frames > 0 else video


def tensor_to_video(tensor, path: str, fps: int = 25, video_format: str = "MP4V") -> None:
    """(frames, H, W, c) float in [0, 1] -> MP4 through cv2."""
    import cv2

    frames = np.clip(_host_array(tensor) * 255.0, 0, 255).astype(np.uint8)
    _, H, W, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*video_format), fps, (W, H))
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
