"""A batch of images as one PNG grid (counterpart of
phenaki_tpu/utils/image_grid.py)."""

from __future__ import annotations

import math

import numpy as np
from PIL import Image


def make_image_grid(images: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """(n, H, W, c) float in [0, 1] -> one (H', W', c) grid, `nrow` images a
    row, `padding` zero pixels around each."""
    n, H, W, c = images.shape
    rows = math.ceil(n / nrow)
    grid = np.zeros((rows * (H + padding) + padding, nrow * (W + padding) + padding, c), np.float32)
    for idx in range(n):
        r, col = divmod(idx, nrow)
        y, x = r * (H + padding) + padding, col * (W + padding) + padding
        grid[y: y + H, x: x + W] = images[idx]
    return grid


def save_image_grid(images, path: str, nrow: int = 8) -> None:
    """Write `images` (n, H, W, c), a numpy array or a tensor, as a PNG grid."""
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    grid = make_image_grid(np.asarray(images, np.float32), nrow=nrow)
    arr = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(path)
