"""Lookup-free quantization, decode side (counterpart of
phenaki_tpu/ops/quantize.py: `LFQ.indices_to_codes`)."""

from __future__ import annotations

import math

import torch
from torch import nn


class LFQ(nn.Module):
    """Sign-bit codes over {-1, +1}^log2(K): bit b of an index maps to +1,
    else -1; `project_out` (bits -> dim, no bias) when dim != bits."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        bits = int(math.log2(codebook_size))
        if 2**bits != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.codebook_dim = bits
        self.project_out = nn.Linear(bits, dim, bias=False) if dim != bits else None

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        powers = 2 ** torch.arange(self.codebook_dim, device=indices.device)
        bits = (indices[..., None] & powers) > 0
        dtype = self.project_out.weight.dtype if self.project_out is not None else torch.float32
        codes = torch.where(bits, 1.0, -1.0).to(dtype)
        if self.project_out is not None:
            codes = self.project_out(codes)
        return codes
