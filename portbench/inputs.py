"""The one generator of every traffic mix: it reads the parameters of a
traffic file (`traffic/<cell>.json`) and makes a run's inputs from its
seed, on the device, in bulk. Nothing here depends on the cell's name.

* Text: T5-base-width embeddings (`text_dim`), each prompt a length drawn
  uniformly from `text_len` = [lo, hi] tokens, zero-padded to
  `max_text_len` rows (the port reads the non-zero rows as its text mask).
* Token ids: C-ViViT codebook ids over the whole vocabulary, uniform.
* Arrivals (open loop): `count` = round(rate x seconds) requests, their due
  times uniform over the window and sorted: a Poisson process of that rate
  conditioned on its count, so every seed offers the same work in another
  order.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np
import torch

from portbench.common import subseed

TEXT, IDS, ARRIVALS, ORDER = range(4)


def text_embeds(seed: int, count: int, *, text_dim: int, max_text_len: int, text_len, device) -> torch.Tensor:
    """(count, max_text_len, text_dim) float32, row r real up to its length."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, TEXT))
    lo, hi = text_len
    lengths = torch.randint(lo, hi + 1, (count,), generator=gen, device=device)
    emb = torch.randn(count, max_text_len, text_dim, generator=gen, device=device)
    real = torch.arange(max_text_len, device=device)[None, :] < lengths[:, None]
    return emb * real[..., None]


def token_ids(seed: int, shape, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(subseed(seed, IDS))
    return torch.randint(0, vocab, tuple(shape), generator=gen, device=device)


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Sorted due times (s from the window's start) of round(rate x seconds)
    requests."""
    count = int(round(rate * seconds))
    rng = np.random.default_rng(subseed(seed, ARRIVALS))
    return np.sort(rng.uniform(0.0, seconds, count))


def permutation(seed: int, n: int, key: int = ORDER) -> List[int]:
    order = list(range(n))
    random.Random(subseed(seed, key)).shuffle(order)
    return order


def call_rows(seed: int, call: int, batch: int, pool: int) -> List[int]:
    """The prompts of closed-loop call `call`: `batch` rows of a pool of
    `pool` prompts, walked in a seeded order."""
    order = permutation(seed, pool)
    return [order[(call * batch + r) % pool] for r in range(batch)]
