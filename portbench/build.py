"""The system under test, built from a configuration file with the port's
public constructors (`presets.flagship_cvivit`, `flagship_maskgit`,
`flagship_token_critic`, `Phenaki`) under the card's device context, then
given the benchmark's seeded weights (`weights.make`): no weight is drawn on
the host. (Built under the `meta` device context instead, the modules took
7.5-9 s on the H100 machine with torch 2.11, which imported torch._dynamo
for it; under the card's, 0.09 s.)

`mode` "sample" builds what a server runs (every module in the served dtype,
`precision.serve`); "train" what a trainer trains (the MaskGit's and the
critic's parameters in `precision.train_params`, computing in
`precision.train_compute`; the frozen C-ViViT in the served dtype)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench import weights as W

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def num_tokens(config: dict) -> Tuple[int, Tuple[int, int, int]]:
    """Tokens of one clip and its latent grid (t, h, w)."""
    c = config["cvivit"]
    frames = config["sampling"]["num_frames"]
    H, Wd = c["image_size"]
    grid = (1 + (frames - 1) // c["temporal_patch_size"], H // c["patch_size"], Wd // c["patch_size"])
    return grid[0] * grid[1] * grid[2], grid


def modules(config: dict, mode: str, device: str) -> Dict[str, torch.nn.Module]:
    from phenaki_tpu_torch import presets

    prec = config["precision"]
    serve = DTYPES[prec["serve"]]
    compute = DTYPES[prec["train_compute"]] if mode == "train" else None
    params = DTYPES[prec["train_params"]] if mode == "train" else serve
    c = dict(config["cvivit"], image_size=tuple(config["cvivit"]["image_size"]))
    with torch.device(device):
        mods = {"cvivit": presets.flagship_cvivit(**c).to(serve),
                "maskgit": presets.flagship_maskgit(dtype=compute, **config["maskgit"]).to(params)}
        if config.get("critic"):
            mods["critic"] = presets.flagship_token_critic(dtype=compute, **config["critic"]).to(params)
    return mods


def dtypes_of(mods: Dict[str, torch.nn.Module]) -> Dict[str, torch.dtype]:
    return {k: next(m.parameters()).dtype for k, m in mods.items()}


def build(config: dict, seed: int, device: str, mode: str):
    """(phenaki, weight layout, weight dtypes): the port's Phenaki with the
    benchmark's weights of `seed` on `device`."""
    from phenaki_tpu_torch.models.phenaki import Phenaki

    mods = modules(config, mode, device)
    spec, dtypes = W.layout(mods), dtypes_of(mods)
    weights = W.make(spec, seed, device, dtypes)
    W.load(mods, weights)
    del weights
    s = config["sampling"]
    ph = Phenaki(maskgit=mods["maskgit"], cvivit=mods["cvivit"], text_embed_dim=s["text_dim"],
                 steps=s["steps"], max_text_len=s["max_text_len"], critic=mods.get("critic"))
    return ph, spec, dtypes
