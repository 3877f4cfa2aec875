"""The T5 encoder stack, written in PyTorch (counterpart of
phenaki_tpu/text/t5_jax.py).

T5 and T5-v1.1 encoders: token embedding -> N x [RMSNorm -> self-attention
(a learned, bucketed relative position bias computed once and shared by
every block, as HF computes it in block 0; no 1/sqrt(d) scaling) ->
residual; RMSNorm -> feed-forward (gated tanh-GELU for v1.1, ReLU for the
original T5) -> residual] -> final RMSNorm; padded positions are zeroed on
output, so the model downstream recovers the text mask as
`any(embed != 0, -1)`. The attention is plain torch, as the JAX package's
is plain `einsum`s outside any Pallas kernel: softmax in f32 over scores
plus the bias, the padded keys at `finfo(float32).min`.

`convert_hf_state_dict` maps a HuggingFace `T5EncoderModel` state_dict onto
the stack (both store Linear weights as (out, in): names change, layouts
do not), `load_hf_t5` loads a checkpoint from disk (`transformers` imported
inside, `local_files_only`), and `TorchT5Encoder` is the text -> (b, L, d)
encoder on the card unless asked otherwise. `bridge.load_t5_params` loads
the JAX stack's flax variables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_act: bool = True  # v1.1 gated-gelu; False: the original T5's relu

    @classmethod
    def from_hf(cls, hf_config) -> "T5EncoderConfig":
        """From a transformers `T5Config`."""
        proj = getattr(hf_config, "feed_forward_proj", "relu")
        return cls(
            vocab_size=hf_config.vocab_size,
            d_model=hf_config.d_model,
            d_kv=hf_config.d_kv,
            num_heads=hf_config.num_heads,
            d_ff=hf_config.d_ff,
            num_layers=hf_config.num_layers,
            relative_attention_num_buckets=hf_config.relative_attention_num_buckets,
            relative_attention_max_distance=getattr(hf_config, "relative_attention_max_distance", 128),
            layer_norm_epsilon=hf_config.layer_norm_epsilon,
            gated_act=getattr(hf_config, "is_gated_act", "gated" in proj),
        )


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucketing of key - query offsets (numpy: the
    sequence length fixes them)."""
    rel = np.asarray(relative_position, np.int64)
    num_buckets //= 2
    buckets = (rel > 0).astype(np.int64) * num_buckets
    rel = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_clip = np.maximum(rel, 1)  # log(0) never used: is_small covers it
    if_large = max_exact + (np.log(rel_clip.astype(np.float64) / max_exact) / np.log(max_distance / max_exact)
                            * (num_buckets - max_exact)).astype(np.int64)
    if_large = np.minimum(if_large, num_buckets - 1)
    return buckets + np.where(is_small, rel, if_large)


class T5RMSNorm(nn.Module):
    """T5's LayerNorm: no mean, no bias; the statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight.to(x.dtype) * x32.to(x.dtype)


class T5SelfAttention(nn.Module):
    """Multi-head self-attention as T5 has it: no q scaling (folded into the
    weights), an additive position bias, no biases on the projections."""

    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) + position_bias
        probs = scores.softmax(dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhjd->bhid", probs, v).transpose(1, 2).reshape(b, n, -1)
        return self.o(out)


class T5FeedForward(nn.Module):
    """wo(gelu_tanh(wi_0 x) * wi_1 x), or wo(relu(wi x))."""

    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.gated = cfg.gated_act
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)  # HF's gelu_new
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.attn_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5SelfAttention(cfg)
        self.ff_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ff = T5FeedForward(cfg)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), position_bias)
        return x + self.ff(self.ff_norm(x))


class T5EncoderStack(nn.Module):
    """The whole encoder: `forward(input_ids, attention_mask)` -> the final
    hidden states (b, n, d_model), padded positions zero."""

    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # (buckets, heads), HF's relative_attention_bias of block 0
        self.rel_bias = nn.Parameter(torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads))
        self.blocks = nn.ModuleList(T5Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def position_bias(self, n: int, attention_mask: torch.Tensor) -> torch.Tensor:
        """(b, heads, n, n) f32: the bucketed bias, and finfo(f32).min at
        padded keys; one for every block."""
        cfg = self.cfg
        pos = np.arange(n)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        bias = self.rel_bias[torch.from_numpy(buckets).to(self.rel_bias.device)]  # (n, n, heads)
        bias = bias.permute(2, 0, 1)[None].float()
        key_mask = attention_mask[:, None, None, :].bool()
        return torch.where(key_mask, bias, torch.finfo(torch.float32).min)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.token_embed(input_ids)
        bias = self.position_bias(input_ids.shape[1], attention_mask)
        for block in self.blocks:
            x = block(x, bias)
        x = self.final_norm(x)
        return x * attention_mask[..., None].to(x.dtype)


def convert_hf_state_dict(state_dict: Dict[str, Any], cfg: T5EncoderConfig) -> Dict[str, torch.Tensor]:
    """A HuggingFace `T5EncoderModel` state_dict as `T5EncoderStack`'s
    (f32 tensors; both keep Linear weights (out, in))."""

    def t(key):
        return torch.as_tensor(np.asarray(state_dict[key].detach().cpu() if hasattr(state_dict[key], "detach")
                                          else state_dict[key]), dtype=torch.float32)

    embed = "shared.weight" if "shared.weight" in state_dict else "encoder.embed_tokens.weight"
    out = {"token_embed.weight": t(embed),
           "rel_bias": t("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           "final_norm.weight": t("encoder.final_layer_norm.weight")}
    for i in range(cfg.num_layers):
        pre, blk = f"encoder.block.{i}", f"blocks.{i}"
        for name in ("q", "k", "v", "o"):
            out[f"{blk}.attn.{name}.weight"] = t(f"{pre}.layer.0.SelfAttention.{name}.weight")
        out[f"{blk}.attn_norm.weight"] = t(f"{pre}.layer.0.layer_norm.weight")
        for name in (("wi_0", "wi_1") if cfg.gated_act else ("wi",)) + ("wo",):
            out[f"{blk}.ff.{name}.weight"] = t(f"{pre}.layer.1.DenseReluDense.{name}.weight")
        out[f"{blk}.ff_norm.weight"] = t(f"{pre}.layer.1.layer_norm.weight")
    return out


def load_hf_t5(name: str, dtype: torch.dtype = torch.float32):
    """(stack, cfg) from a T5 checkpoint on disk: `name` a directory, or a
    hub name resolved against `PHENAKI_T5_PATH` and the transformers cache
    (`text.t5.resolve_t5_source`); nothing is downloaded. On the CPU, in
    `dtype`; raises where no checkpoint is found."""
    from transformers import T5Config as HFT5Config
    from transformers import T5EncoderModel

    from phenaki_tpu_torch.text.t5 import resolve_t5_source

    source = resolve_t5_source(name)
    cfg = T5EncoderConfig.from_hf(HFT5Config.from_pretrained(source, local_files_only=True))
    hf_model = T5EncoderModel.from_pretrained(source, local_files_only=True)
    stack = T5EncoderStack(cfg)
    stack.load_state_dict(convert_hf_state_dict(hf_model.state_dict(), cfg))
    return stack.to(dtype).eval(), cfg


class TorchT5Encoder:
    """Texts -> (b, L, d) float32 numpy embeddings with the reference's
    contract (padded positions zero), the stack on `device` (the card
    unless asked otherwise; `to` moves it). Needs the tokenizer and the
    weights on disk."""

    def __init__(self, name: str, max_length: int = 256, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        from phenaki_tpu_torch.text.spm_tokenizer import load_t5_tokenizer
        from phenaki_tpu_torch.text.t5 import resolve_t5_source

        self.tokenizer = load_t5_tokenizer(resolve_t5_source(name), max_length=max_length)
        self.model, self.cfg = load_hf_t5(name, dtype=dtype)
        self.max_length = max_length
        self.to(device)

    def to(self, device) -> "TorchT5Encoder":
        self.model.to(device)
        return self

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer(list(texts), return_tensors="pt", padding="longest", max_length=self.max_length,
                             truncation=True)
        device = self.model.rel_bias.device
        with torch.no_grad():
            out = self.model(enc["input_ids"].to(device), enc["attention_mask"].to(device))
        return out.float().cpu().numpy()
