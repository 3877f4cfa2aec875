"""Seeded weights made on the device in a few large calls.

The layout (`layout`) lists each parameter's name, shape and distribution,
read once from the modules the benchmark built: PyTorch's defaults, as
`phenaki_tpu_torch` draws them (a Linear's or PEG's weight and bias
U(+-1/sqrt(fan_in)), an embedding and the null key/values N(0, 1), norm gains
and q/k scales 1, norm biases 0). `make` then draws every uniform number
with one `torch.rand` and every normal one with one `torch.randn` from a
generator on the device, and slices them into tensors of the served dtype.
The same (layout, seed, dtype) gives the same tensors, which is how the
reference gets the weights the program got without reading the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

Layout = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, kind, bound

_ONES = ("gamma", "q_scale", "k_scale")
_ZEROS = ("beta",)


def layout(modules: Dict[str, nn.Module]) -> Layout:
    """(name, shape, kind, bound) of every parameter of `modules` (prefix ->
    module), in module order; kind is uniform, normal, ones or zeros."""
    out: Layout = []
    for prefix, module in modules.items():
        for mod_name, mod in module.named_modules():
            for p_name, p in mod.named_parameters(recurse=False):
                name = f"{prefix}.{mod_name}.{p_name}" if mod_name else f"{prefix}.{p_name}"
                shape = tuple(p.shape)
                if p_name in _ONES:
                    out.append((name, shape, "ones", 0.0))
                elif p_name in _ZEROS:
                    out.append((name, shape, "zeros", 0.0))
                elif isinstance(mod, nn.Embedding) or p_name == "null_kv":
                    out.append((name, shape, "normal", 1.0))
                elif p_name in ("weight", "bias"):
                    fan_in = mod.weight[0].numel()
                    out.append((name, shape, "uniform", fan_in ** -0.5))
                else:
                    raise ValueError(f"no rule for parameter {name}")
    return out


def make(spec: Layout, seed: int, device, dtype: Dict[str, torch.dtype]) -> Dict[str, torch.Tensor]:
    """The weights of `spec` from `seed` on `device`; `dtype` maps a name's
    prefix (before the first dot) to the dtype its tensors are made in."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {k: sum(int(torch.Size(s).numel()) for _, s, kind, _ in spec if kind == k) for k in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    used = {"uniform": 0, "normal": 0}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind, bound in spec:
        t_dtype = dtype[name.split(".", 1)[0]]
        numel = int(torch.Size(shape).numel())
        if kind in pools:
            start = used[kind]
            used[kind] += numel
            t = pools[kind][start:start + numel].view(shape)
            t = (t * (2 * bound) - bound) if kind == "uniform" else t
            out[name] = t.to(t_dtype)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "ones" else 0.0, dtype=t_dtype, device=device)
    return out


def load(modules: Dict[str, nn.Module], weights: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the modules' parameters (names as `layout`)."""
    for prefix, module in modules.items():
        cut = len(prefix) + 1
        module.load_state_dict({k[cut:]: v for k, v in weights.items() if k.split(".", 1)[0] == prefix},
                               strict=True)
