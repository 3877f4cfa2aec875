"""VGG16 features for the perceptual loss (counterpart of
phenaki_tpu/models/vgg.py), written out in torch without torchvision.

The conv trunk of torchvision's vgg16 (13 3 x 3 convs with ReLU, 5 max
pools), a resize of the trunk's output to 7 x 7, then fc1 and fc2 with
ReLU: (b, H, W, 3) frames in [0, 1] -> (b, 4096) features, the reference's
VGG with its last two classifier layers stripped. Frames are channels-last
as in the TPU package; the convs run channels-first on a channels-last view.

* The 7 x 7 step is the TPU package's `jax.image.resize(method="linear")`,
  not torch's adaptive average pool: a separable triangle filter that, where
  it shrinks an axis, is widened by the scale and so averages
  (antialiased). `resize_weights` builds JAX's `scale_and_translate` weights
  exactly. At 256 x 128 the trunk ends at 8 x 4: H shrinks 8 -> 7 and W
  grows 4 -> 7.
* Without pretrained weights `init_vgg` draws a fixed-seed random VGG with
  He-normal weights (truncated at two deviations, as flax's `he_normal`) and
  zero biases: random convolutional features keep unit-scale signal through
  the ReLU chain.
* A pool is skipped where the frame is already under 2 pixels on a side
  (tiny test inputs), as in the TPU package.
* `load_torch_state_dict` takes a torchvision vgg16 state dict, already in
  this module's layout (conv (out, in, kh, kw), linear (out, in)), and maps
  its names: `features.{k}` -> `conv_{i}`, `classifier.0` -> `fc1`,
  `classifier.3` -> `fc2`. `load_vgg16_from_file` reads one from a `.pth`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.models.cvivit import conv2d
from phenaki_tpu_torch.ops.feedforward import linear

# torchvision vgg16 conv plan: channels per conv, "M" = max pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")
POOL_HW = (7, 7)
FEATURES = 4096


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of JAX's linear `scale_and_translate`
    along one axis (antialiased: a shrink widens the triangle by the scale)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def linear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(b, H, W, c) -> (b, oh, ow, c): `jax.image.resize(x, ..., "linear")`.
    An axis whose size does not change is left as it is."""
    (H, W), (oh, ow) = x.shape[1:3], out_hw
    if H != oh:
        x = torch.einsum("bhwc,ho->bowc", x, resize_weights(H, oh, x.device).to(x.dtype))
    if W != ow:
        x = torch.einsum("bhwc,wo->bhoc", x, resize_weights(W, ow, x.device).to(x.dtype))
    return x


def _conv_names():
    return [f"conv_{i}" for i in range(sum(1 for s in VGG16_PLAN if s != "M"))]


class VGG16Features(nn.Module):
    """Conv trunk, the 7 x 7 resize, fc1 and fc2 (ReLU): (b, H, W, 3) ->
    (b, 4096), computing in `dtype` (None: the weights' dtype)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        cin = 3
        convs = iter(_conv_names())
        for spec in VGG16_PLAN:
            if spec != "M":
                self.add_module(next(convs), nn.Conv2d(cin, spec, 3, padding=1))
                cin = spec
        self.fc1 = nn.Linear(cin * POOL_HW[0] * POOL_HW[1], FEATURES)
        self.fc2 = nn.Linear(FEATURES, FEATURES)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.fc1.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        convs = iter(_conv_names())
        for spec in VGG16_PLAN:
            if spec == "M":
                if min(x.shape[2:]) >= 2:
                    x = F.max_pool2d(x, 2)
            else:
                x = F.relu(conv2d(x, getattr(self, next(convs))))
        x = linear_resize(x.permute(0, 2, 3, 1), POOL_HW)
        # torchvision flattens (c, h, w); so do the converted weights
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = F.relu(linear(x, self.fc1))
        return F.relu(linear(x, self.fc2))


@torch.no_grad()
def init_vgg(seed: int = 0, device="cpu", dtype: Optional[torch.dtype] = None) -> VGG16Features:
    """A fixed-seed random VGG16Features on `device`, computing in `dtype`:
    He-normal weights truncated at two deviations, zero biases, drawn in f32
    on the CPU from `torch.Generator().manual_seed(seed)`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        model = VGG16Features(dtype=dtype)
    model.to_empty(device="cpu")
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            # flax he_normal: variance 2 / fan_in after truncation at +-2 sd
            std = (2.0 / mod.weight[0].numel()) ** 0.5 / 0.87962566103423978
            mod.weight.copy_(_truncated_normal(mod.weight.shape, gen).mul_(std))
            mod.bias.zero_()
    return model.to(device)


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], by redrawing those outside."""
    w = torch.empty(shape).normal_(generator=gen).reshape(-1)
    while True:
        bad = (w.abs() > 2).nonzero().squeeze(1)
        if bad.numel() == 0:
            return w.reshape(shape)
        w.index_copy_(0, bad, torch.empty(bad.numel()).normal_(generator=gen))


def load_torch_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state dict -> a VGG16Features state dict (the
    layouts agree; only the names change)."""
    conv_keys = sorted((k for k in state_dict if k.startswith("features.") and k.endswith(".weight")),
                       key=lambda k: int(k.split(".")[1]))
    out = {}
    for name, wkey in zip(_conv_names(), conv_keys, strict=True):
        out[f"{name}.weight"] = state_dict[wkey]
        out[f"{name}.bias"] = state_dict[wkey[: -len("weight")] + "bias"]
    for name, tkey in (("fc1", "classifier.0"), ("fc2", "classifier.3")):
        out[f"{name}.weight"] = state_dict[f"{tkey}.weight"]
        out[f"{name}.bias"] = state_dict[f"{tkey}.bias"]
    return out


def load_vgg16_from_file(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state-dict file (.pth) -> a VGG16Features state
    dict; `CViViTTrainer(vgg_params=...)` takes it, or reads the file named
    by PHENAKI_VGG16_PATH when `perceptual_mode="vgg"`."""
    return load_torch_state_dict(torch.load(path, map_location="cpu", weights_only=True))
