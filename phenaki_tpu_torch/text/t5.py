"""Frozen T5 text encoding (counterpart of phenaki_tpu/text/t5.py).

`t5_encode_text(texts, name) -> (b, L, d)` float32 numpy with padded
positions zeroed (the model recovers the text mask as `any(embed != 0, -1)`),
`get_encoded_dim(name)` and `DEFAULT_T5_NAME`; one encoder per (name,
fallback_dim, device), cached for the process.

Backends, in order, as the TPU package's `get_text_encoder` tries them:

1. The port's own encoder stack (`t5_torch.TorchT5Encoder`, the counterpart
   of the TPU package's `JaxT5Encoder`) loaded with a T5 checkpoint's
   weights when they are on disk (a local directory, `PHENAKI_T5_PATH`, or
   a warm cache; nothing is downloaded).
2. HuggingFace `transformers` `T5EncoderModel` on the same weights, where
   the first did not load.
3. Otherwise `HashTextEncoder`: a deterministic offline encoder on the host.

The first two run on `device` (the card unless the caller asks for
another; `Phenaki.embed_texts` passes the MaskGit's); their tokenizer is
`AutoTokenizer`, or the sentencepiece-free conversion of `spiece.model`
(`spm_tokenizer.py`).
   Tokens (lower-case words and single punctuation marks) map to Gaussian
   vectors seeded by their blake2b hash, plus a sinusoid by position; its
   output equals the TPU package's bit for bit.

`transformers`, `tokenizers` and protobuf are imported only inside the
functions that need them, so the package imports without them.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

MAX_LENGTH = 256
DEFAULT_T5_NAME = "google/t5-v1_1-base"

# d_model of common T5 checkpoints, so no config has to be fetched
T5_EMBED_DIMS = {
    "google/t5-v1_1-small": 512,
    "google/t5-v1_1-base": 768,
    "google/t5-v1_1-large": 1024,
    "google/t5-v1_1-xl": 2048,
    "google/t5-v1_1-xxl": 4096,
    "t5-small": 512,
    "t5-base": 768,
    "t5-large": 1024,
}

_ENCODERS: dict = {}


def resolve_t5_source(name: str) -> str:
    """What `from_pretrained` should load: `name` itself when it is a local
    directory (config.json, the weights and spiece.model), else the
    directory in `PHENAKI_T5_PATH` when set, else the hub name."""
    if os.path.isdir(name):
        return name
    env = os.environ.get("PHENAKI_T5_PATH")
    if env and os.path.isdir(env):
        return env
    return name


def get_encoded_dim(name: str = DEFAULT_T5_NAME) -> int:
    source = resolve_t5_source(name)
    if source == name and name in T5_EMBED_DIMS:
        return T5_EMBED_DIMS[name]
    try:  # a local directory or the transformers cache, no download
        from transformers import T5Config

        return T5Config.from_pretrained(source, local_files_only=True).d_model
    except Exception:  # noqa: BLE001
        if name in T5_EMBED_DIMS:
            return T5_EMBED_DIMS[name]
        raise ValueError(f"unknown t5 name {name!r} and no local config cached") from None


class HashTextEncoder:
    """Deterministic offline text encoder with the T5 output contract."""

    def __init__(self, dim: int, max_length: int = MAX_LENGTH):
        self.dim = dim
        self.max_length = max_length

    @staticmethod
    def _tokenize(text: str) -> List[str]:
        return re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())

    def _token_vec(self, token: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.blake2b(token.encode(), digest_size=8).digest(), "little")
        rng = np.random.default_rng(seed)
        return rng.standard_normal(self.dim).astype(np.float32) / np.sqrt(self.dim)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        toks = [self._tokenize(t)[: self.max_length] for t in texts]
        max_len = max(max((len(t) for t in toks), default=1), 1)
        out = np.zeros((len(texts), max_len, self.dim), np.float32)
        pos = np.arange(max_len)[:, None]
        dim_i = np.arange(self.dim)[None, :]
        sinusoid = np.where(
            dim_i % 2 == 0,
            np.sin(pos / 10000 ** (dim_i / self.dim)),
            np.cos(pos / 10000 ** ((dim_i - 1) / self.dim)),
        ).astype(np.float32) * 0.1
        for i, ts in enumerate(toks):
            for j, tok in enumerate(ts):
                out[i, j] = self._token_vec(tok) + sinusoid[j]
            if not ts:  # an empty text still gives one non-zero position
                out[i, 0] = self._token_vec("") + sinusoid[0]
        return out


class _HFT5Encoder:
    """transformers' T5 encoder, loaded on the CPU and moved with `to`;
    numpy out."""

    def __init__(self, name: str):
        from transformers import T5EncoderModel

        from phenaki_tpu_torch.text.spm_tokenizer import load_t5_tokenizer

        source = resolve_t5_source(name)
        self.tokenizer = load_t5_tokenizer(source)
        self.model = T5EncoderModel.from_pretrained(source, local_files_only=True).eval()

    def to(self, device) -> "_HFT5Encoder":
        self.model.to(device)
        return self

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer(list(texts), return_tensors="pt", padding="longest",
                             max_length=MAX_LENGTH, truncation=True)
        device = self.model.device
        ids, mask = enc["input_ids"].to(device), enc["attention_mask"].to(device)
        with torch.no_grad():
            out = self.model(input_ids=ids, attention_mask=mask).last_hidden_state
        out = out.masked_fill(~mask[..., None].bool(), 0.0)
        return out.float().cpu().numpy()


def _torch_t5_encoder(name: str):
    from phenaki_tpu_torch.text.t5_torch import TorchT5Encoder

    return TorchT5Encoder(name, max_length=MAX_LENGTH, device="cpu")


def get_text_encoder(name: str = DEFAULT_T5_NAME, fallback_dim: Optional[int] = None, device="cuda"):
    """One encoder per (name, fallback_dim, device): the port's T5 stack on
    `device` where a checkpoint's weights are on disk, else HF's T5 there,
    else the hash encoder, of width `fallback_dim` when given (a model's
    explicit text_embed_dim) or the checkpoint's."""
    key = (name, fallback_dim, str(device))
    if key not in _ENCODERS:
        encoder = None
        for build in (_torch_t5_encoder, _HFT5Encoder):
            try:  # each loads on the host
                encoder = build(name)
                break
            except Exception:  # noqa: BLE001 — no weights on disk: the next backend
                continue
        if encoder is None:
            dim = fallback_dim if fallback_dim is not None else get_encoded_dim(name)
            encoder = HashTextEncoder(dim)
        else:
            encoder.to(device)  # outside the try: a missing device raises
        _ENCODERS[key] = encoder
    return _ENCODERS[key]


def t5_encode_text(texts, name: str = DEFAULT_T5_NAME, fallback_dim: Optional[int] = None,
                   device="cuda") -> np.ndarray:
    """texts (a string or a sequence) -> (b, L, d) float32, padded positions
    zero; an HF T5 encoder runs on `device`."""
    if isinstance(texts, str):
        texts = [texts]
    return get_text_encoder(name, fallback_dim, device)(texts)
