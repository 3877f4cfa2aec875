"""Reconstruction quality metrics (counterpart of phenaki_tpu/utils/metrics.py)."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB of (b, ...) in [0, max_val],
    averaged over the batch; computed in f32, the MSE floored at 1e-10."""
    pred, target = pred.float(), target.float()
    mse = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.ndim)))
    return (10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-10))).mean()


@torch.no_grad()
def reconstruction_psnr(cvivit, videos: torch.Tensor) -> torch.Tensor:
    """PSNR of the C-ViViT's round trip (eval mode) on (b, f, H, W, c) videos in [0, 1]."""
    was_training = cvivit.training
    cvivit.eval()
    try:
        recon, _, _ = cvivit(videos)
    finally:
        cvivit.train(was_training)
    return psnr(recon.float().clamp(0.0, 1.0), videos)
