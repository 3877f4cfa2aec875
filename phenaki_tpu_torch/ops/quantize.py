"""Vector-quantization bottlenecks (counterpart of phenaki_tpu/ops/quantize.py).

Both return `QuantizerOutput(quantized, indices, aux_loss)` from a forward
over (b, n, dim) and map indices back to code vectors for the decoder.

* `LFQ`, lookup-free quantization: `project_in` (dim -> bits, no bias) when
  dim != bits, sign codes over {-1, +1}^bits in f32, index = sum_b (z_b > 0)
  2^b, a straight-through output through `project_out`, and an aux loss:
  the entropy term (per-sample entropy minus `diversity_gamma` times the
  codebook entropy of the codes' softmax at `inv_temperature`; the exact
  softmax over all 2^bits codes up to `full_entropy_max_bits`, the
  factorized per-bit form above, whose binary
  entropy clips p to [1e-6, 1 - 1e-6]) and the commitment term.
* `VectorQuantize`: cosine-similarity argmax over an l2-normalised codebook,
  a mask-aware commitment loss, and the EMA codebook update, which changes
  the `embed` and `cluster_size` buffers in place (the TPU package's
  mutable `vq_stats` collection, `codebook` and `cluster_size`).

A mask (b, n) bool weighs every loss term and statistic by position.

`batch_group` (a data-parallel process group, set by a trainer) makes the
batch statistics those of the global batch: the position count, the LFQ's
codebook usage (`collectives.sum_over_group`, whose backward suits averaged
gradients) and the VQ's EMA counts and sums, as JAX computes them over the
whole sharded batch and keeps `vq_stats` replicated. Each rank's losses
then average to the global batch's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from phenaki_tpu_torch.ops.feedforward import linear
from phenaki_tpu_torch.parallel import collectives


class QuantizerOutput(NamedTuple):
    quantized: torch.Tensor
    indices: torch.Tensor
    aux_loss: torch.Tensor


def _binary_entropy(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # the clip keeps the gradient finite where p saturates at 0 or 1
    p = p.clamp(eps, 1.0 - eps)
    return -(p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))


def _entropy(probs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return -(probs * torch.log(probs.clamp_min(eps))).sum(-1)


def _weights(z: torch.Tensor, mask: Optional[torch.Tensor], group=None):
    """Per-position weights (b, n) f32 and their sum, at least 1; over a
    group of n ranks the global sum / n (the ranks' losses then average to
    the global loss)."""
    w = torch.ones(z.shape[:-1], device=z.device) if mask is None else mask.float()
    n = collectives.group_size(group)
    return w, (collectives.all_reduce(w.sum(), group) / n).clamp_min(1.0 / n)


def _lfq_codebook(bits: int, device) -> torch.Tensor:
    """All 2^bits sign codes: row k has bit b = +1 iff (k >> b) & 1."""
    ks = torch.arange(2**bits, device=device)[:, None]
    return torch.where((ks >> torch.arange(bits, device=device)) & 1 > 0, 1.0, -1.0)


class LFQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, *, entropy_loss_weight: float = 0.1,
                 commitment_loss_weight: float = 0.25, diversity_gamma: float = 1.0,
                 inv_temperature: float = 100.0, full_entropy_max_bits: int = 13):
        super().__init__()
        self.inv_temperature = inv_temperature
        self.full_entropy_max_bits = full_entropy_max_bits
        bits = int(math.log2(codebook_size))
        if 2**bits != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.codebook_dim = bits
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.diversity_gamma = diversity_gamma
        has_projections = dim != bits
        self.project_in = nn.Linear(dim, bits, bias=False) if has_projections else None
        self.project_out = nn.Linear(bits, dim, bias=False) if has_projections else None
        self.batch_group = None

    def _powers(self, device) -> torch.Tensor:
        return 2 ** torch.arange(self.codebook_dim, device=device)

    def pre_sign(self, x: torch.Tensor) -> torch.Tensor:
        """The activations z (b, n, bits) whose signs are the code, in f32."""
        z = linear(x, self.project_in) if self.project_in is not None else x
        return z.float()

    def codes_to_indices(self, z: torch.Tensor) -> torch.Tensor:
        """Index sum_b (z_b > 0) 2^b, int64."""
        return ((z > 0).long() * self._powers(z.device)).sum(-1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> QuantizerOutput:
        """x (b, n, dim) -> (quantized (b, n, dim), indices (b, n), aux_loss)."""
        z = self.pre_sign(x)
        codes = torch.where(z > 0, 1.0, -1.0)
        indices = self.codes_to_indices(z)
        quantized = z + (codes - z).detach()  # straight through
        group = self.batch_group
        weights, denom = _weights(z, mask, group)
        # the global batch's mean usage: the ranks' sums over their count
        usage_denom = denom * collectives.group_size(group)

        if self.codebook_dim <= self.full_entropy_max_bits:
            logits = torch.einsum("bnd,kd->bnk", z, _lfq_codebook(self.codebook_dim, z.device))
            probs = torch.softmax(logits * self.inv_temperature, dim=-1)
            per_sample_entropy = (_entropy(probs) * weights).sum() / denom
            avg_probs = collectives.sum_over_group((probs * weights[..., None]).sum(dim=(0, 1)),
                                                   group) / usage_denom
            codebook_entropy = _entropy(avg_probs)
        else:  # the softmax over sign codes factorizes per bit
            p_bit = torch.sigmoid(2.0 * z * self.inv_temperature)
            per_sample_entropy = (_binary_entropy(p_bit).sum(-1) * weights).sum() / denom
            avg_p_bit = collectives.sum_over_group((p_bit * weights[..., None]).sum(dim=(0, 1)),
                                                   group) / usage_denom
            codebook_entropy = _binary_entropy(avg_p_bit).sum()
        entropy_aux = per_sample_entropy - self.diversity_gamma * codebook_entropy
        commit = (((z - codes) ** 2).mean(-1) * weights).sum() / denom
        aux_loss = self.entropy_loss_weight * entropy_aux + self.commitment_loss_weight * commit

        out = quantized.to(x.dtype)
        if self.project_out is not None:
            out = linear(out, self.project_out)
        return QuantizerOutput(out, indices, aux_loss)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        bits = (indices[..., None] & self._powers(indices.device)) > 0
        dtype = self.project_out.weight.dtype if self.project_out is not None else torch.float32
        codes = torch.where(bits, 1.0, -1.0).to(dtype)
        if self.project_out is not None:
            codes = self.project_out(codes)
        return codes


def _l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / t.norm(dim=-1, keepdim=True).clamp_min(eps)


class VectorQuantize(nn.Module):
    """Cosine-similarity VQ with EMA codebook updates; the codebook `embed`
    (K, dim) and `cluster_size` (K,) are buffers, not parameters. `decay` is
    the EMA's, `eps` the cluster sizes' Laplace smoothing, and
    `commitment_weight` scales the aux loss."""

    def __init__(self, dim: int, codebook_size: int, *, decay: float = 0.8,
                 commitment_weight: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.codebook_size = codebook_size
        self.decay, self.commitment_weight, self.eps = decay, commitment_weight, eps
        self.register_buffer("embed", torch.randn(codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.batch_group = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                update_codebook: bool = True) -> QuantizerOutput:
        """x (b, n, dim); mask (b, n) bool: only True positions count in the
        commitment loss and the EMA statistics."""
        z_n = _l2norm(x.float())
        cb_n = _l2norm(self.embed.float())
        indices = torch.einsum("bnd,kd->bnk", z_n, cb_n).argmax(dim=-1)
        quantized = cb_n[indices]
        weights, denom = _weights(z_n, mask, self.batch_group)
        commit = (((z_n - quantized.detach()) ** 2).mean(-1) * weights).sum() / denom
        aux_loss = commit * self.commitment_weight
        if update_codebook:
            self._ema_update(z_n.detach(), indices, weights)
        quantized_st = z_n + (quantized - z_n).detach()
        return QuantizerOutput(quantized_st.to(x.dtype), indices, aux_loss)

    @torch.no_grad()
    def _ema_update(self, z_n, indices, weights) -> None:
        one_hot = torch.nn.functional.one_hot(indices, self.codebook_size).float() * weights[..., None]
        counts = collectives.all_reduce(one_hot.sum(dim=(0, 1)), self.batch_group)
        sums = collectives.all_reduce(torch.einsum("bnk,bnd->kd", one_hot, z_n), self.batch_group)
        decay, eps = self.decay, self.eps
        new_cluster = self.cluster_size * decay + counts * (1 - decay)
        n = new_cluster.sum()
        smoothed = (new_cluster + eps) / (n + self.codebook_size * eps) * n
        ema_embed = self.embed * decay + sums * (1 - decay)
        new_embed = torch.where(counts[:, None] > 0, ema_embed / smoothed[:, None].clamp_min(eps),
                                self.embed)
        self.cluster_size.copy_(new_cluster)
        self.embed.copy_(new_embed)

    def codebook_lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """The unit-norm code vectors of `indices`."""
        return _l2norm(self.embed.float())[indices]
