"""Load the TPU package's flax parameter trees into the port's modules.

The trees arrive as nested dicts of numpy arrays (`jax.device_get` of the
flax params), so this module needs no JAX. Mapping rules:

* `layers_{i}` -> `layers.{i}`; a `layers_scan` subtree (the `scan_layers`
  layout, every leaf with a leading depth axis) is unstacked into
  `layers.0` ... `layers.{depth-1}`;
* Dense / projection `kernel` (in, out) -> Linear `weight` (out, in); the
  fused `to_kv` keeps its column order, k in the first half and v in the
  second, which is the port's `to_kv` row order;
* nn.Embed `embedding` -> `weight`;
* the PEG kernel (3, 3, 3, 1, d) -> the depthwise Conv3d weight (d, 1, 3, 3, 3);
* `net_hidden_{i}` -> `net_hidden.{i}`;
* everything else (bias, gamma, beta, null_kv with the k rows first,
  q_scale, k_scale) keeps its name and layout.

The same rules load a TokenCritic's tree and a SelfCritic's `{"to_pred"}`
head; `load_phenaki_params` takes the `{"maskgit", "critic"}` dict of the
TPU package's `Phenaki.init`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(layers|net_hidden)_(\d+)$")


def _convert_leaf(name: str, arr: np.ndarray, parent: str):
    if name == "embedding":
        return "weight", arr
    if name == "kernel":
        if arr.ndim == 5:  # PEG (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"unexpected kernel rank {arr.ndim} under {parent!r}")
    return name, arr


def flax_to_state_dict(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into a port `state_dict` (f32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if key == "layers_scan":
            depth = len(next(iter(_leaves(val))))
            for i in range(depth):
                layer = _map_leaves(val, lambda a, i=i: a[i])
                out.update(flax_to_state_dict(layer, f"{prefix}layers.{i}."))
            continue
        m = _INDEXED.match(key)
        name = f"{m.group(1)}.{m.group(2)}" if m else key
        if isinstance(val, Mapping):
            out.update(flax_to_state_dict(val, f"{prefix}{name}."))
        else:
            leaf, arr = _convert_leaf(name, np.asarray(val), prefix)
            out[f"{prefix}{leaf}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into `module`. Entries the module does not have
    (the C-ViViT encoder, for the decode-only port) are ignored; a parameter
    of the module with no entry, or a shape mismatch, raises."""
    sd = flax_to_state_dict(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"flax tree lacks {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    for name, target in own.items():
        src = sd[name]
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{name}: flax {tuple(src.shape)} vs port {tuple(target.shape)}")
        target.copy_(src.to(target.dtype))
    return module


def load_phenaki_params(phenaki, params: Mapping):
    """Copy the TPU package's `Phenaki.init` parameters, `{"maskgit": ...,
    "critic": ...}`, into a port `Phenaki`: the critic's tree is a
    TokenCritic's, a SelfCritic's head `{"to_pred": ...}` (its trunk is the
    MaskGit's), or None without a critic."""
    load_flax_params(phenaki.maskgit, params["maskgit"])
    tree = params.get("critic")
    if (tree is None) != (phenaki.critic is None):
        raise ValueError("the tree and the Phenaki disagree on having a critic")
    if tree is not None:
        load_flax_params(phenaki.critic, tree)
    return phenaki
