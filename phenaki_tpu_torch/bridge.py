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
* a 2-D conv kernel (kh, kw, in, out) -> the Conv2d weight (out, in, kh, kw);
* `net_hidden_{i}` -> `net_hidden.{i}`;
* everything else (bias, gamma, beta, null_kv with the k rows first,
  q_scale, k_scale) keeps its name and layout.

The same rules load a TokenCritic's tree and a SelfCritic's `{"to_pred"}`
head; `load_phenaki_params` takes the `{"maskgit", "critic"}` dict of the
TPU package's `Phenaki.init`, and `load_cvivit_variables` a C-ViViT's whole
variables, `{"params", "vq_stats"}`: a cosine VQ keeps its codebook in the
`vq_stats` collection (`codebook` -> the `embed` buffer, `cluster_size`).
`load_discriminator_params` and `load_vgg_params` take a `Discriminator`'s
and a `VGG16Features`' variables (`{"params": ...}`, or the params alone):
the port names their submodules as flax does (`block_{i}`, `attn_{i}`,
`conv_{i}`), so the rules above are all they need.

Loading is strict both ways: every parameter and buffer of the module must
have an entry, and every entry must land in the module. No tree the TPU
package builds for a ported module carries an entry the port drops.

`load_t5_params` loads the TPU package's `t5_jax.T5EncoderStack` variables
into the port's `text.t5_torch.T5EncoderStack`: its flat `block_{i}_attn`,
`block_{i}_attn_norm`, `block_{i}_ff` and `block_{i}_ff_norm` become
`blocks.{i}.attn`, `.attn_norm`, `.ff` and `.ff_norm`.

`load_tp_flax_params` loads a tree into rank r's tensor-parallel clone
(`parallel.tp_inference.tp_local_module`), by either route: the tree as it
is, packed here (`pack_tp_params` on the bridged state_dict), or a tree that
JAX's `pack_tp_params` packed already (`packed=True`); both give the same
tensors, bit for bit.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(layers|net_hidden)_(\d+)$")
_T5_BLOCK = re.compile(r"^block_(\d+)_(attn_norm|attn|ff_norm|ff)\.")


def _convert_leaf(name: str, arr: np.ndarray, parent: str):
    if name == "embedding":
        return "weight", arr
    if name == "kernel":
        if arr.ndim == 5:  # PEG (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 4:  # Conv (kh, kw, in, out) -> (out, in, kh, kw)
            return "weight", np.transpose(arr, (3, 2, 0, 1))
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


def _listed(names) -> str:
    return f"{names[:8]}{' ...' if len(names) > 8 else ''}"


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into `module`. A parameter or buffer of the
    module with no entry, an entry that lands nowhere in the module, or a
    shape mismatch raises."""
    return _load_state(module, flax_to_state_dict(tree))


def tp_flax_state_dict(tree: Mapping, tp: int, rank: int, packed: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s share of a flax tree as a tp-local state_dict; `packed`
    when JAX's `pack_tp_params` was applied to the tree."""
    from phenaki_tpu_torch.parallel.tp_inference import pack_tp_params, shard_packed

    sd = flax_to_state_dict(tree)
    return shard_packed(sd if packed else pack_tp_params(sd, tp), tp, rank)


def load_tp_flax_params(module: nn.Module, tree: Mapping, tp: int, rank: int,
                        packed: bool = False) -> nn.Module:
    """Copy rank `rank`'s share of a flax tree into its tp-local clone
    `module`, as strictly as `load_flax_params`."""
    return _load_state(module, tp_flax_state_dict(tree, tp, rank, packed))


@torch.no_grad()
def _load_state(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"flax tree lacks {_listed(missing)}")
    unused = sorted(set(sd) - set(own))
    if unused:
        raise KeyError(f"flax entries land nowhere in {type(module).__name__}: {_listed(unused)}")
    for name, target in own.items():
        src = sd[name]
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{name}: flax {tuple(src.shape)} vs port {tuple(target.shape)}")
        target.copy_(src.to(target.dtype))
    return module


def load_t5_params(stack, variables: Mapping):
    """Copy the TPU package's T5 encoder stack variables (`{"params": ...}`
    or the params alone) into a port `T5EncoderStack` of the same
    configuration."""
    sd = flax_to_state_dict(_params(variables))
    return _load_state(stack, {_T5_BLOCK.sub(r"blocks.\1.\2.", k): v for k, v in sd.items()})


def load_cvivit_variables(cvivit, variables: Mapping):
    """Copy the TPU package's C-ViViT variables, `{"params": ...}` and, for a
    cosine VQ, `{"vq_stats": {"vq": {"codebook", "cluster_size"}}}`, into a
    port `CViViT`."""
    tree = dict(variables["params"])
    if "vq_stats" in variables:
        stats = variables["vq_stats"]["vq"]
        tree["vq"] = {"embed": stats["codebook"], "cluster_size": stats["cluster_size"]}
    return load_flax_params(cvivit, tree)


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


def _params(variables: Mapping) -> Mapping:
    return variables["params"] if "params" in variables else variables


def load_discriminator_params(discr, variables: Mapping):
    """Copy the TPU package's `Discriminator` variables into a port
    `Discriminator` of the same configuration."""
    return load_flax_params(discr, _params(variables))


def load_vgg_params(vgg, variables: Mapping):
    """Copy the TPU package's `VGG16Features` variables into a port
    `VGG16Features`."""
    return load_flax_params(vgg, _params(variables))
