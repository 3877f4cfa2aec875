"""Seeded parameter initialisation with PyTorch's default distributions
(counterpart of phenaki_tpu/ops/torch_init.py).

Linear and Conv3d weights and biases: U(+-1/sqrt(fan_in)); Embedding,
null_kv and a VQ codebook: N(0, 1); q_scale, k_scale and LayerNorm gamma:
ones; beta and a VQ's cluster sizes: zeros. Every draw comes from the given
generator, in module order; `skip` leaves modules (and what they hold) out.
"""

from __future__ import annotations

import torch
from torch import nn

from phenaki_tpu_torch.ops.attention import Attention
from phenaki_tpu_torch.ops.norms import LayerNorm, StandardLayerNorm
from phenaki_tpu_torch.ops.positional import PEG
from phenaki_tpu_torch.ops.quantize import VectorQuantize


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator, skip=()) -> nn.Module:
    skipped = {id(m) for top in skip for m in top.modules()}
    for mod in model.modules():
        if id(mod) in skipped:
            continue
        if isinstance(mod, (nn.Linear, PEG)):
            bound = mod.weight[0].numel() ** -0.5
            mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=generator)
        elif isinstance(mod, (LayerNorm, StandardLayerNorm)):
            mod.gamma.fill_(1.0)
            if isinstance(mod, StandardLayerNorm):
                mod.beta.zero_()
        elif isinstance(mod, Attention):
            if mod.null_kv is not None:
                mod.null_kv.normal_(generator=generator)
            mod.q_scale.fill_(1.0)
            mod.k_scale.fill_(1.0)
        elif isinstance(mod, VectorQuantize):
            mod.embed.normal_(generator=generator)
            mod.cluster_size.zero_()
    return model
