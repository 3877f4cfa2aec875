"""Reference-checkpoint converters: load `lucidrains/phenaki-pytorch` torch
`state_dict`s into the port's modules (counterpart of
phenaki_tpu/convert.py).

A user of the reference brings their trained weights:

    maskgit = MaskGit(..., reference_attention_kv=True)
    maskgit.load_state_dict(convert_maskgit_state_dict(torch.load("maskgit.pt"), maskgit))
    cvivit = CViViT(..., peg_reference_layout=True, reference_attention_kv=True)
    cvivit.load_state_dict(convert_cvivit_state_dict(torch.load("cvivit.pt")["model"], cvivit))

Each converter returns a state_dict for the module it is given, whose keys
are the module's own; the caller loads it. Both are torch, so a Linear
weight keeps its (out, in) layout and the PEG's depthwise weight its
(dim, 1, kt, kh, kw). The layouts that differ (reference attention.py /
cvivit.py / phenaki_pytorch.py @ 2024-08-07):

  * the reference stores null key/values interleaved: `null_kv[h, 2i]` is
    the i-th null key and `null_kv[h, 2i+1]` the i-th null value
    (attention.py:148, `'h (n r) d'` with r = 2); the port stores all keys,
    then all values;
  * the reference's bias-less LayerNorm keeps a frozen all-zero `beta`
    buffer in its state_dict (attention.py:29-36); it must be zero and is
    dropped. The FF block's inner LayerNorm is a regular one;
  * transformer layers are tuples (peg, self_attn, cross_attn, ff) indexed
    0..3; the CPB MLP is `net.0.0`, `net.k.0`, `net.<layers>`; the patch
    embeddings are Sequential(Rearrange, LN, Linear, LN).

The C-ViViT's quantizer lives in an external dependency
(`vector-quantize-pytorch`): LFQ's `vq.project_in/out` weights and the
cosine VQ's codebook `vq._codebook.embed` map where present; the module's
own values stay for what is missing, and other `vq.*` keys are ignored.

The reference takes self-attention K/V from the pre-norm input and, in the
C-ViViT, reads the temporal PEG on a scrambled grid: its weights need a
module built with `reference_attention_kv=True` (and, for the C-ViViT,
`peg_reference_layout=True`), and the converters refuse one built without.

`strict` (the default) raises on a reference key that lands nowhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def _num_null_kv(model) -> int:
    """The null key/value pairs of the model's cross-attention (0 without
    one): the reference's weights hold 2, and `_attention` refuses others."""
    cross = model.transformer.layers[0].cross_attn if len(model.transformer.layers) else None
    return cross.num_null_kv if cross is not None else 0


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class _SD:
    """State-dict view with consumption tracking."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = ""):
        self.sd = dict(sd)
        self.prefix = prefix
        self.consumed: set = set()

    def sub(self, prefix: str) -> "_SD":
        child = _SD.__new__(_SD)
        child.sd = self.sd
        child.prefix = self.prefix + prefix
        child.consumed = self.consumed
        return child

    def take(self, key: str) -> np.ndarray:
        full = self.prefix + key
        self.consumed.add(full)
        return _np(self.sd[full])

    def has(self, key: str) -> bool:
        return (self.prefix + key) in self.sd

    def take_zero_beta(self, key: str) -> None:
        """Consume a frozen-zero beta buffer, checking that it is zero."""
        full = self.prefix + key
        if full in self.sd:
            v = _np(self.sd[full])
            if not np.allclose(v, 0.0):
                raise ValueError(f"{full} expected to be the reference's frozen-zero LayerNorm beta"
                                 f" but is non-zero (max |v|={np.abs(v).max()})")
            self.consumed.add(full)

    def unused(self) -> List[str]:
        return sorted(k for k in self.sd if k not in self.consumed)


def _attention(sd: _SD, out: Dict[str, np.ndarray], prefix: str, num_null_kv: int,
               cross: bool) -> None:
    for name in ("to_q.weight", "to_kv.weight", "to_out.weight", "q_scale", "k_scale", "norm.gamma"):
        out[prefix + name] = sd.take(name)
    sd.take_zero_beta("norm.beta")
    null_kv = sd.take("null_kv")  # (h, 2n, d), interleaved k/v pairs
    if num_null_kv > 0:
        h, two_n, d = null_kv.shape
        if two_n != 2 * num_null_kv:
            raise ValueError(f"{sd.prefix}null_kv holds {two_n} rows, not {2 * num_null_kv}")
        pairs = null_kv.reshape(h, num_null_kv, 2, d)
        out[prefix + "null_kv"] = np.concatenate([pairs[:, :, 0], pairs[:, :, 1]], axis=1)
    if cross:
        out[prefix + "context_norm.gamma"] = sd.take("context_norm.gamma")
        sd.take_zero_beta("context_norm.beta")
    elif sd.has("context_norm.gamma"):
        # the reference's self-attention builds (and checkpoints) an unused
        # context_norm; consume it so that strict mode stays clean
        sd.take("context_norm.gamma")
        sd.take_zero_beta("context_norm.beta")


def _transformer(sd: _SD, out: Dict[str, np.ndarray], prefix: str, *, depth: int, peg: bool,
                 has_cross_attn: bool, num_null_kv: int) -> None:
    """Reference Transformer (attention.py:279-332): layer tuples (peg?,
    self_attn, cross_attn?, ff) with None placeholders kept, so the indices
    are 0 = peg, 1 = self_attn, 2 = cross_attn, 3 = ff."""
    for i in range(depth):
        layer_sd, layer = sd.sub(f"layers.{i}."), f"{prefix}layers.{i}."
        if peg:
            out[layer + "peg.weight"] = layer_sd.take("0.dsconv.weight")  # (dim, 1, kt, kh, kw)
            out[layer + "peg.bias"] = layer_sd.take("0.dsconv.bias")
        _attention(layer_sd.sub("1."), out, layer + "self_attn.", num_null_kv=0, cross=False)
        if has_cross_attn:
            _attention(layer_sd.sub("2."), out, layer + "cross_attn.", num_null_kv=num_null_kv,
                       cross=True)
        ff = layer_sd.sub("3.")
        out[layer + "ff.norm.gamma"] = ff.take("0.weight")
        out[layer + "ff.norm.beta"] = ff.take("0.bias")
        out[layer + "ff.proj_in.weight"] = ff.take("1.weight")
        out[layer + "ff.proj_out.weight"] = ff.take("4.weight")
    out[prefix + "norm_out.gamma"] = sd.take("norm_out.gamma")
    sd.take_zero_beta("norm_out.beta")


def _cpb(sd: _SD, out: Dict[str, np.ndarray], prefix: str, layers: int = 2) -> None:
    """ContinuousPositionBias MLP (attention.py:229-275): net.0.0 -> net_in,
    net.k.0 -> net_hidden.{k-1}, net.<layers> -> net_out."""
    for param in ("weight", "bias"):
        out[f"{prefix}net_in.{param}"] = sd.take(f"net.0.0.{param}")
        for k in range(1, layers):
            out[f"{prefix}net_hidden.{k - 1}.{param}"] = sd.take(f"net.{k}.0.{param}")
        out[f"{prefix}net_out.{param}"] = sd.take(f"net.{layers}.{param}")


def _state_dict(module: nn.Module, converted: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The module's state_dict with the converted entries in place (f32);
    an entry the module lacks, or of another shape, raises."""
    own = module.state_dict()
    out = {k: v.detach().clone() for k, v in own.items()}
    for key, arr in converted.items():
        if key not in own:
            raise KeyError(f"converted entry {key} lands nowhere in {type(module).__name__}")
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: reference {tuple(arr.shape)} vs port {tuple(own[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def _finish(s: _SD, module: nn.Module, converted, strict: bool, ignore=()) -> Dict[str, torch.Tensor]:
    unused = [k for k in s.unused() if not k.startswith(ignore)]
    if strict and unused:
        raise ValueError(f"unconverted reference keys: {unused}")
    return _state_dict(module, converted)


def _refuse_unflagged(module: nn.Module, name: str) -> None:
    if not module.reference_attention_kv:
        raise ValueError(f"construct the {name} with reference_attention_kv=True: reference weights"
                         " expect self-attention K/V from the pre-norm input"
                         " (reference attention.py:138-142)")


def convert_maskgit_state_dict(sd: Mapping[str, Any], maskgit, strict: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """Reference MaskGit (phenaki_pytorch.py:105-213) state_dict -> a
    state_dict for the port's `maskgit` (built with
    `reference_attention_kv=True`); load it with `maskgit.load_state_dict`."""
    _refuse_unflagged(maskgit, "MaskGit")
    s, out = _SD(sd), {}
    out["token_emb.weight"] = s.take("token_emb.weight")
    out["pos_emb.weight"] = s.take("pos_emb.weight")
    _cpb(s.sub("continuous_pos_bias."), out, "continuous_pos_bias.")
    _transformer(s.sub("transformer."), out, "transformer.", depth=len(maskgit.transformer.layers),
                 peg=True, has_cross_attn=not maskgit.unconditional, num_null_kv=_num_null_kv(maskgit))
    out["to_logits.weight"] = s.take("to_logits.weight")
    out["to_logits.bias"] = s.take("to_logits.bias")
    return _finish(s, maskgit, out, strict)


def convert_token_critic_state_dict(sd: Mapping[str, Any], critic, strict: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """Reference TokenCritic (phenaki_pytorch.py:217-302) state_dict -> a
    state_dict for the port's `critic` (built with
    `reference_attention_kv=True`); load it with `critic.load_state_dict`."""
    _refuse_unflagged(critic, "TokenCritic")
    s, out = _SD(sd), {}
    out["token_emb.weight"] = s.take("token_emb.weight")
    out["pos_emb.weight"] = s.take("pos_emb.weight")
    _transformer(s.sub("transformer."), out, "transformer.", depth=len(critic.transformer.layers),
                 peg=True, has_cross_attn=critic.has_cross_attn, num_null_kv=_num_null_kv(critic))
    out["to_logits.weight"] = s.take("to_logits.0.weight")
    out["to_logits.bias"] = s.take("to_logits.0.bias")
    return _finish(s, critic, out, strict)


def convert_cvivit_state_dict(sd: Mapping[str, Any], cvivit, strict: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """Reference CViViT (cvivit.py:226-671) state_dict -> a state_dict for
    the port's `cvivit` (built with `peg_reference_layout=True` and
    `reference_attention_kv=True`); load it with `cvivit.load_state_dict`.

    Pass the model's state_dict without the VGG (the reference's
    checkpoints leave it out, cvivit.py:423-429); discriminator keys
    (`discr.*`) are ignored: the tokenizer Phenaki uses carries none."""
    if not (cvivit.peg_reference_layout and cvivit.reference_attention_kv):
        raise ValueError("construct the CViViT with peg_reference_layout=True and"
                         " reference_attention_kv=True: reference weights expect the scrambled"
                         " temporal-PEG grid (reference attention.py:71) and pre-norm"
                         " self-attention K/V (attention.py:138-142)")
    s, out = _SD(sd), {}
    for k in s.sd:
        if k.startswith(("discr.", "vgg.")):
            s.consumed.add(k)
    _cpb(s.sub("spatial_rel_pos_bias."), out, "spatial_rel_pos_bias.")
    for ref, port in (("to_patch_emb_first_frame.", "first"), ("to_patch_emb.", "rest")):
        emb = s.sub(ref)
        out[f"patch_norm_in_{port}.gamma"] = emb.take("1.weight")
        out[f"patch_norm_in_{port}.beta"] = emb.take("1.bias")
        out[f"patch_proj_{port}.weight"] = emb.take("2.weight")
        out[f"patch_proj_{port}.bias"] = emb.take("2.bias")
        out[f"patch_norm_out_{port}.gamma"] = emb.take("3.weight")
        out[f"patch_norm_out_{port}.beta"] = emb.take("3.bias")
    for name in ("enc_spatial_transformer", "enc_temporal_transformer",
                 "dec_spatial_transformer", "dec_temporal_transformer"):
        trunk = getattr(cvivit, name)
        _transformer(s.sub(name + "."), out, name + ".", depth=len(trunk.layers),
                     peg="temporal" in name, has_cross_attn=False, num_null_kv=0)
    out["to_pixels_first.weight"] = s.take("to_pixels_first_frame.0.weight")
    out["to_pixels_first.bias"] = s.take("to_pixels_first_frame.0.bias")
    out["to_pixels_rest.weight"] = s.take("to_pixels.0.weight")
    out["to_pixels_rest.bias"] = s.take("to_pixels.0.bias")
    for proj in ("project_in", "project_out"):
        if s.has(f"vq.{proj}.weight"):
            out[f"vq.{proj}.weight"] = s.take(f"vq.{proj}.weight")
    if s.has("vq._codebook.embed"):
        emb = s.take("vq._codebook.embed")
        out["vq.embed"] = emb[0] if emb.ndim == 3 else emb
    return _finish(s, cvivit, out, strict, ignore=("vq.",))
