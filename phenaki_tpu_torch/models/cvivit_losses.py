"""The VQGAN losses of C-ViViT training (counterpart of
phenaki_tpu/models/cvivit_losses.py).

* masked MSE reconstruction (a (b, f) frame mask counts unmasked frames);
* the perceptual term on one random frame a video: VGG16 feature MSE
  (`"vgg"`), the MSE of unit-normalised discriminator block features
  (`"disc"`, the TPU package's default), or none;
* hinge or BCE GAN losses;
* the adaptive generator weight ||d perc / d W_pix|| / ||d gen / d W_pix||
  over the pixel heads' weights and biases (with `"none"`, the recon loss
  takes the perceptual term's place), clamped at 1e4 and detached;
* the R1-style gradient penalty on the real frames, weight 10.

The frames are drawn by `pick_random_frame_indices` from a torch
`Generator`; both loss functions also take `frame_indices=` (a test passes
the TPU package's draw). The pixel heads act only on the decoder's output,
so their gradient in the loss's own graph is the TPU package's gradient
with that output held constant: the adaptive weight differentiates the
loss terms over the heads alone (`torch.autograd.grad` with the graph
kept), not the whole C-ViViT.

`dp_group` makes a loss one data-parallel rank's share of the global
batch's, whose rows the ranks' loaders interleave (rank r of n holds rows r,
r + n, ...): the judged frames are drawn for the global batch and the rank
keeps its rows, and the adaptive weight's gradients are averaged over the
group before their norms, as the global batch's loss gives them. The
C-ViViT's quantizer statistics follow its `batch_group`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from phenaki_tpu_torch.models.cvivit import CViViT, Discriminator
from phenaki_tpu_torch.models.vgg import VGG16Features
from phenaki_tpu_torch.parallel import collectives

ADAPTIVE_WEIGHT_MAX = 1e4
GRAD_PENALTY_WEIGHT = 10.0


def hinge_discr_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (F.relu(1 + fake) + F.relu(1 - real)).mean()


def hinge_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return -fake.mean()


def _log(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return torch.log(t + eps)


def bce_discr_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (-_log(1 - torch.sigmoid(fake)) - _log(torch.sigmoid(real))).mean()


def bce_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return (-_log(torch.sigmoid(fake))).mean()


def safe_div(numer, denom, eps: float = 1e-8):
    return numer / (denom + eps)


def pick_random_frame_indices(generator: Optional[torch.Generator], batch: int, frames: int,
                              mask: Optional[torch.Tensor] = None, device=None,
                              dp_group=None) -> torch.Tensor:
    """One random frame a video, among its unmasked frames: the argmax of
    standard normal draws (from `generator`, on the CPU) -> (batch,) int64
    on `device`; over `dp_group` drawn for the global batch, this rank's
    rows kept."""
    shards = collectives.group_size(dp_group)
    logits = collectives.batch_rows(torch.randn(batch * shards, frames, generator=generator),
                                    collectives.group_rank(dp_group), shards).to(device)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(logits.device), -torch.inf)
    return logits.argmax(dim=-1)


def pick_video_frame(video: torch.Tensor, frame_indices: torch.Tensor) -> torch.Tensor:
    """video (b, f, H, W, c), indices (b,) -> frames (b, H, W, c)."""
    return video[torch.arange(video.shape[0], device=video.device), frame_indices.to(video.device)]


def _lift_to_rgb(frame: torch.Tensor) -> torch.Tensor:
    """A grayscale frame as 3 equal channels, for the VGG."""
    return frame.expand(*frame.shape[:-1], 3) if frame.shape[-1] == 1 else frame


def disc_perceptual_features(discr: Discriminator, frame: torch.Tensor) -> List[torch.Tensor]:
    """The discriminator's block activations, f32, each unit-normalised over
    its channels (LPIPS's normalisation)."""
    _, feats = discr(frame, return_features=True)
    out = []
    for f in feats:
        f = f.float()
        out.append(f * torch.rsqrt((f * f).sum(-1, keepdim=True) + 1e-8))
    return out


def _disc_perceptual_loss(feats_a, feats_b) -> torch.Tensor:
    return sum(((a - b) ** 2).mean() for a, b in zip(feats_a, feats_b))


def masked_recon_loss(video: torch.Tensor, recon: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """MSE in f32; with a (b, f) frame mask only unmasked frames count."""
    err = (video.float() - recon.float()) ** 2
    if mask is None:
        return err.mean()
    w = mask.float()[:, :, None, None, None]
    denom = torch.clamp(w.sum() * err.shape[2] * err.shape[3] * err.shape[4], min=1.0)
    return (err * w).sum() / denom


def _pixel_head_params(cvivit: CViViT) -> List[torch.nn.Parameter]:
    return [cvivit.to_pixels_first.weight, cvivit.to_pixels_first.bias,
            cvivit.to_pixels_rest.weight, cvivit.to_pixels_rest.bias]


def _grad_norm(loss: torch.Tensor, params, dp_group=None) -> torch.Tensor:
    grads = [g for g in torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
             if g is not None]
    if collectives.group_size(dp_group) > 1:
        collectives.all_reduce_(grads, dp_group)
        torch._foreach_div_(grads, float(collectives.group_size(dp_group)))
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def cvivit_generator_loss(cvivit: CViViT, video: torch.Tensor, *,
                          generator: Optional[torch.Generator] = None,
                          mask: Optional[torch.Tensor] = None,
                          discr: Optional[Discriminator] = None,
                          vgg: Optional[VGG16Features] = None,
                          use_vgg_and_gan: bool = True, use_hinge_loss: bool = True,
                          update_codebook: bool = False, perceptual_mode: str = "vgg",
                          frame_indices: Optional[torch.Tensor] = None, dp_group=None):
    """The generator phase's loss: (loss, aux) with aux's `recon_loss`,
    `vq_aux_loss`, `recon_video` and, with the GAN suite, `perceptual_loss`,
    `gen_loss` and `adaptive_weight`. `video` (b, f, H, W, c) or an image
    (b, H, W, c). The discriminator's (and the VGG's) parameters must not
    require gradients here: the loss moves the C-ViViT only.
    `update_codebook` moves a cosine VQ's codebook EMA."""
    out = cvivit.forward_intermediates(video, mask=mask, update_codebook=update_codebook)
    is_image = video.ndim == 4
    video5 = video[:, None] if is_image else video
    recon5 = out["recon_video"][:, None] if is_image else out["recon_video"]

    recon_loss = masked_recon_loss(video5, recon5, mask)
    vq_aux_loss = out["vq_aux_loss"]
    aux = dict(recon_loss=recon_loss, vq_aux_loss=vq_aux_loss, recon_video=out["recon_video"])
    if not use_vgg_and_gan:
        loss = recon_loss + vq_aux_loss
        aux["loss"] = loss
        return loss, aux

    if discr is None:
        raise ValueError("the GAN losses need a discriminator")
    if perceptual_mode not in ("vgg", "disc", "none"):
        raise ValueError(f"perceptual_mode {perceptual_mode!r}")
    if perceptual_mode == "vgg" and vgg is None:
        raise ValueError('perceptual_mode="vgg" needs a VGG16Features')

    b, f = video5.shape[:2]
    if frame_indices is None:
        frame_indices = pick_random_frame_indices(generator, b, f, mask, device=video.device,
                                                  dp_group=dp_group)
    input_frame = pick_video_frame(video5, frame_indices)
    recon_frame = pick_video_frame(recon5, frame_indices)

    if perceptual_mode == "vgg":
        with torch.no_grad():
            input_feats = vgg(_lift_to_rgb(input_frame)).float()
        perceptual_loss = ((input_feats - vgg(_lift_to_rgb(recon_frame)).float()) ** 2).mean()
    elif perceptual_mode == "disc":
        with torch.no_grad():
            input_feats = disc_perceptual_features(discr, input_frame)
        perceptual_loss = _disc_perceptual_loss(input_feats, disc_perceptual_features(discr, recon_frame))
    else:
        perceptual_loss = torch.zeros((), device=video.device)

    gen_loss_fn = hinge_gen_loss if use_hinge_loss else bce_gen_loss
    gen_loss = gen_loss_fn(discr(recon_frame).float())

    # adaptive weight over the pixel heads (detached)
    heads = _pixel_head_params(cvivit)
    numer = recon_loss if perceptual_mode == "none" else perceptual_loss
    adaptive_weight = safe_div(_grad_norm(numer, heads, dp_group), _grad_norm(gen_loss, heads, dp_group))
    adaptive_weight = adaptive_weight.clamp(max=ADAPTIVE_WEIGHT_MAX).detach()

    loss = recon_loss + perceptual_loss + vq_aux_loss + adaptive_weight * gen_loss
    aux.update(perceptual_loss=perceptual_loss, gen_loss=gen_loss, adaptive_weight=adaptive_weight,
               loss=loss)
    return loss, aux


def gradient_penalty(discr: Discriminator, images: torch.Tensor,
                     weight: float = GRAD_PENALTY_WEIGHT) -> torch.Tensor:
    """weight * mean((||d sum(logits) / d image||_2 - 1)^2), differentiable in
    the discriminator's parameters (second order through the discriminator)."""
    images = images.detach().float().requires_grad_()
    (grads,) = torch.autograd.grad(discr(images).float().sum(), images, create_graph=True)
    norms = grads.reshape(grads.shape[0], -1).norm(dim=1)
    return weight * ((norms - 1.0) ** 2).mean()


def cvivit_discriminator_loss(cvivit: CViViT, discr: Discriminator, video: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              mask: Optional[torch.Tensor] = None, apply_grad_penalty: bool = True,
                              use_hinge_loss: bool = True,
                              frame_indices: Optional[torch.Tensor] = None, dp_group=None):
    """The discriminator phase's loss: the reconstruction without a gradient,
    one random frame a video judged real against fake, and on penalty steps
    the gradient penalty on the real frames. (loss, aux) with aux's
    `discr_loss`, `grad_penalty` and `loss`."""
    is_image = video.ndim == 4
    video5 = video[:, None] if is_image else video
    with torch.no_grad():
        recon, _, _ = cvivit(video, mask=mask)
    recon5 = recon[:, None] if is_image else recon

    b, f = video5.shape[:2]
    if frame_indices is None:
        frame_indices = pick_random_frame_indices(generator, b, f, mask, device=video.device,
                                                  dp_group=dp_group)
    real_frame = pick_video_frame(video5, frame_indices)
    fake_frame = pick_video_frame(recon5, frame_indices)

    fake_logits = discr(fake_frame).float()
    real_logits = discr(real_frame).float()
    loss_fn = hinge_discr_loss if use_hinge_loss else bce_discr_loss
    discr_loss = loss_fn(fake_logits, real_logits)
    gp = (gradient_penalty(discr, real_frame) if apply_grad_penalty
          else torch.zeros((), device=video.device))
    loss = discr_loss + gp
    return loss, dict(discr_loss=discr_loss, grad_penalty=gp, loss=loss)
