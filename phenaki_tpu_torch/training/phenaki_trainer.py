"""Phenaki (MaskGit) trainer on pre-tokenized data (counterpart of
phenaki_tpu/training/phenaki_trainer.py, the part this path needs).

The dataset yields tuples whose fields are inferred from their types as in
the TPU package (`determine_field`): pre-tokenized `video_codebook_ids`
(integers), precomputed `text_embeds` (float, (b, L, d) once batched) and an
optional `video_frame_mask` (bool). One `train_step()` runs
`grad_accum_every` micro-batches through `Phenaki.loss` and its backward,
averaging their gradients as `optax.MultiSteps` does, then takes one
optimizer step over the MaskGit and critic parameters. Every random draw of
the loss comes from one CPU generator seeded by `seed`.

As `jax.value_and_grad` does, every parameter gets a gradient each step,
zeros where the loss did not reach it, so Adam's moments and weight decay
move every parameter every step. `only_train_critic` zeroes the MaskGit's
gradients and `only_train_generator` a TokenCritic's, as the TPU step does;
a SelfCritic shares the MaskGit's trunk, and nothing is zeroed for it.

Not accepted yet, so that nothing diverges silently: raw `videos` (they need
the C-ViViT encoder) and `texts` (they need T5); the mesh, FSDP and pipeline
arguments; milestone sampling, GIFs and checkpoints; profiling.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
from torch.utils.data import DataLoader

from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.training.optimizer import get_optimizer

VALID_FIELDS = {"videos", "texts", "video_codebook_ids", "video_frame_mask", "text_embeds"}
NOT_PORTED = {
    "videos": "training from raw videos needs the C-ViViT encoder (ROADMAP A7)",
    "texts": "training from raw texts needs the T5 encoder (ROADMAP A8)",
}


def determine_field(el: Any) -> str:
    """Field of one batched dataset element, by dtype and ndim."""
    if isinstance(el, (list, tuple)) and all(isinstance(x, str) for x in el):
        return "texts"
    t = torch.as_tensor(el)
    if t.dtype == torch.bool:
        return "video_frame_mask"
    if t.is_floating_point():
        if t.ndim == 3:
            return "text_embeds"
        if t.ndim in (4, 5):
            return "videos"
    elif not t.is_complex():
        return "video_codebook_ids"
    raise TypeError(f"unable to determine type of dataset field (shape {tuple(t.shape)})")


def determine_types(data: Sequence[Any]) -> Tuple[str, ...]:
    return tuple(determine_field(el) for el in data)


def cycle(dl: DataLoader) -> Iterator:
    while True:
        yield from dl


class PhenakiTrainer:
    def __init__(self, phenaki: Phenaki, *, dataset, dataset_fields: Optional[Tuple[str, ...]] = None,
                 batch_size: int = 16, grad_accum_every: int = 1, train_lr: float = 1e-4,
                 train_num_steps: int = 100000, max_grad_norm: Optional[float] = None,
                 adam_betas: Tuple[float, float] = (0.9, 0.99), wd: float = 0.0, seed: int = 42,
                 log_every: int = 10):
        if dataset_fields is not None:
            if len(set(dataset_fields)) != len(dataset_fields) or not set(dataset_fields) <= VALID_FIELDS:
                raise ValueError(f"dataset_fields {dataset_fields} must be distinct names in {VALID_FIELDS}")
            self._check_ported(dataset_fields)
        self.model = phenaki
        self.dataset_fields = dataset_fields
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.train_num_steps = train_num_steps
        self.log_every = log_every
        self.step = 0
        self.generator = torch.Generator().manual_seed(seed)
        self.dl = cycle(DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True,
                                   generator=torch.Generator().manual_seed(seed + 1)))
        self.opt = get_optimizer(phenaki.parameters(), lr=train_lr, wd=wd, betas=adam_betas,
                                 max_grad_norm=max_grad_norm)

    @staticmethod
    def _check_ported(fields):
        for name in fields:
            if name in NOT_PORTED:
                raise NotImplementedError(NOT_PORTED[name])

    def data_tuple_to_fields(self, data: Tuple) -> Tuple[str, ...]:
        if self.dataset_fields is None:
            fields = determine_types(data)
            if len(set(fields)) != len(fields):
                raise ValueError(f"dataset fields {fields} are not distinct")
            self._check_ported(fields)
            self.dataset_fields = fields
        return self.dataset_fields

    def _complete_grads(self, only_train_generator: bool, only_train_critic: bool) -> None:
        """Zeros for every parameter the loss did not reach, and for the half
        that is not trained (a TokenCritic's or the MaskGit's)."""
        ph = self.model
        frozen = []
        if ph.critic is not None and not ph.self_token_critic:
            frozen = (list(ph.maskgit.parameters()) if only_train_critic else
                      list(ph.critic.parameters()) if only_train_generator else [])
        frozen_ids = {id(p) for p in frozen}
        for p in ph.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif id(p) in frozen_ids:
                p.grad.zero_()

    def train_step(self, only_train_generator: bool = False, only_train_critic: bool = False
                   ) -> torch.Tensor:
        """One optimizer step; returns the mean micro-batch loss as a device
        scalar (reading it on the host syncs with the card)."""
        total = 0.0
        for _ in range(self.grad_accum_every):
            data = next(self.dl)
            batch = dict(zip(self.data_tuple_to_fields(data), data))
            loss, _ = self.model.loss(**batch, only_train_generator=only_train_generator,
                                      only_train_critic=only_train_critic, generator=self.generator)
            (loss / self.grad_accum_every).backward()
            total = total + loss.detach() / self.grad_accum_every
        self._complete_grads(only_train_generator, only_train_critic)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1
        if self.step % self.log_every == 0:
            print(f"{self.step}: loss: {float(total):.4f}")
        return total

    def train(self):
        while self.step < self.train_num_steps:
            self.train_step()
        print("training complete")
