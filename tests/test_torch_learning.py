"""Learning sanity of the port: its training plumbing must reduce losses
(the counterparts of tests/test_learning.py's two overfit tests, with their
models, optimizer, step count and thresholds), fp32 on the CPU.

Both start from JAX's initial weights, drawn with the JAX tests' keys and
bridged into the port, on the JAX tests' inputs:

* the C-ViViT, recon-only (`cvivit_generator_loss(use_vgg_and_gan=False)`),
  30 Adam steps at lr 3e-3 on one batch: the recon loss of the last step
  below 0.7 of the first, and the reconstruction PSNR up; the first loss is
  JAX's `cvivit_generator_loss` at the same weights (atol 1e-5);
* the MaskGit's masked cross-entropy (`Phenaki.loss` on fixed codebook ids),
  30 Adam steps at lr 3e-3: the last loss below half the first.

JAX's versions are marked slow for their compiles; these run eagerly in a
few seconds.
"""

import numpy as np
import torch

from phenaki_tpu_torch.bridge import load_cvivit_variables, load_phenaki_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.cvivit_losses import cvivit_generator_loss
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.training.optimizer import get_optimizer
from phenaki_tpu_torch.utils.metrics import reconstruction_psnr

# tests/test_learning.py's models and optimizer
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2, spatial_depth=1,
              temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=1, heads=2, dim_head=16, dim_context=16)
LR, STEPS = 3e-3, 30


def test_cvivit_overfits_one_batch():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.cvivit import CViViT as JCViViT
    from phenaki_tpu.models.cvivit_losses import cvivit_generator_loss as jax_generator_loss

    video_np = np.random.RandomState(0).rand(2, 3, 16, 16, 3).astype(np.float32)
    jmodel = JCViViT(**CVIVIT)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(video_np))
    jax_recon = jax.jit(lambda v, x, rng: jax_generator_loss(jmodel, v, x, rng, use_vgg_and_gan=False)[0][1][
        "recon_loss"])(variables, jnp.asarray(video_np), jax.random.PRNGKey(1))

    torch.manual_seed(0)
    model = load_cvivit_variables(CViViT(**CVIVIT), jax.device_get(variables)).train()
    video = torch.from_numpy(video_np)
    psnr_before = float(reconstruction_psnr(model, video))
    opt = get_optimizer(model.parameters(), lr=LR, wd=0.0)
    losses = []
    for _ in range(STEPS):
        loss, aux = cvivit_generator_loss(model, video, use_vgg_and_gan=False)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(aux["recon_loss"].detach()))
    psnr_after = float(reconstruction_psnr(model, video))
    np.testing.assert_allclose(losses[0], float(jax_recon), atol=1e-5)
    assert losses[-1] < losses[0] * 0.7, f"recon loss did not drop: {losses[0]} -> {losses[-1]}"
    assert psnr_after > psnr_before, f"PSNR did not improve: {psnr_before} -> {psnr_after}"


def test_maskgit_overfits_one_batch():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.cvivit import CViViT as JCViViT
    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.models.phenaki import Phenaki as JPhenaki

    jcvivit = JCViViT(**CVIVIT)
    cvivit_vars = jax.jit(jcvivit.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT), cvivit=jcvivit, cvivit_vars=cvivit_vars, steps=4,
                   text_embed_dim=16, max_text_len=4)
    params = jax.device_get(jph.init(jax.random.PRNGKey(1)))
    ids = torch.tensor(np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 2, 2, 2), 0, 64))).long()
    text = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 16).astype(np.float32))

    cvivit = load_cvivit_variables(CViViT(**CVIVIT), jax.device_get(cvivit_vars))
    ph = Phenaki(maskgit=MaskGit(**MASKGIT), cvivit=cvivit, steps=4, text_embed_dim=16, max_text_len=4)
    load_phenaki_params(ph, params)
    opt = get_optimizer(ph.maskgit.parameters(), lr=LR, wd=0.0)
    generator = torch.Generator().manual_seed(4)
    losses = []
    for _ in range(STEPS):
        loss, _ = ph.loss(video_codebook_ids=ids, text_embeds=text, generator=generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, f"CE did not drop: {losses[0]} -> {losses[-1]}"
