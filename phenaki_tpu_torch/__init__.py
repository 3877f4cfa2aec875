"""PyTorch + CUDA port of phenaki_tpu for NVIDIA Hopper (H100).

The JAX package `phenaki_tpu` is the reference; this package keeps its
module layout (ops/, models/, text/, data/, utils/, parallel/, training/,
presets.py) and imports no JAX.
Its hand-written CUDA kernels (csrc/) replace the TPU package's Pallas
kernels on the flagship text-to-video sampling path (plain, critic-guided
and the logits path) and the MaskGit and critic training path:

* ops/flash_attention.py  <-> phenaki_tpu/ops/pallas_attention.py
  (the forward and its dQ, dK/dV and dBias backward kernels)
* ops/fused_sampling.py   <-> phenaki_tpu/ops/pallas_sampling.py
  (the fused projection sampler and the logits-path sampler)
* ops/fused_ce.py         <-> phenaki_tpu/ops/pallas_ce.py
  (the fused vocab cross-entropy and its dh and dW backward kernels)

The kernels are built with nvcc at first CUDA use (_build.py). Each wrapper
takes its plain PyTorch version only for a CPU tensor.

Serving (serving.py: `PhenakiServer`, `serve_http`) and the converters of
reference phenaki-pytorch checkpoints (convert.py) sit on top; the package
exports the JAX package's top-level names, imported at first use.
"""

import importlib

# lazy top-level exports, as the JAX package's: `import phenaki_tpu_torch._build`
# stays cheap and pulls in no model, trainer or data module
_EXPORTS = {
    "CViViT": "phenaki_tpu_torch.models.cvivit",
    "Discriminator": "phenaki_tpu_torch.models.cvivit",
    "MaskGit": "phenaki_tpu_torch.models.maskgit",
    "TokenCritic": "phenaki_tpu_torch.models.maskgit",
    "SelfCritic": "phenaki_tpu_torch.models.maskgit",
    "Phenaki": "phenaki_tpu_torch.models.phenaki",
    "make_video": "phenaki_tpu_torch.models.phenaki",
    "CViViTTrainer": "phenaki_tpu_torch.training.cvivit_trainer",
    "PhenakiTrainer": "phenaki_tpu_torch.training.phenaki_trainer",
    "PhenakiServer": "phenaki_tpu_torch.serving",
    "serve_http": "phenaki_tpu_torch.serving",
    "convert_cvivit_state_dict": "phenaki_tpu_torch.convert",
    "convert_maskgit_state_dict": "phenaki_tpu_torch.convert",
    "convert_token_critic_state_dict": "phenaki_tpu_torch.convert",
    "flagship_cvivit": "phenaki_tpu_torch.presets",
    "flagship_maskgit": "phenaki_tpu_torch.presets",
    "flagship_token_critic": "phenaki_tpu_torch.presets",
    "flagship_phenaki": "phenaki_tpu_torch.presets",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'phenaki_tpu_torch' has no attribute {name!r}")
