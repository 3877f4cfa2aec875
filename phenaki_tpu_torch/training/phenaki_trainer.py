"""Phenaki (MaskGit + critic) trainer (counterpart of
phenaki_tpu/training/phenaki_trainer.py).

The data: a `dataset=` of tuples, or a `folder=` of GIF/MP4 videos
(`VideoDataset`) or, with `train_on_images`, of images (`ImageDataset`),
loaded by the port's `DataLoader` (string-aware collate, seeded shuffle)
in `LOADER_WORKERS` worker processes that decode, collate and cast
batches ahead of the step, across epoch ends (the TPU package's loader
decodes on 4 threads and prefetches in a background thread); a dataset's
items must not touch the card.
A tuple's fields are inferred from their types as in the TPU package
(`determine_field`): raw `videos` (float, (b, f, H, W, c), or (b, H, W, c)
images), caption `texts` (strings), `video_codebook_ids` (integers),
`text_embeds` (float, (b, L, d)) and `video_frame_mask` (bool). Float pixel
fields are cast to the C-ViViT's dtype as they are collated, in the workers. One
`train_step()` runs `grad_accum_every` micro-batches; each embeds its texts
(`Phenaki.embed_texts`) and goes through `Phenaki.loss`, whose frozen
C-ViViT tokenizes raw pixels without a gradient, and its backward. The
micro-batch gradients are averaged as `optax.MultiSteps` does, then one
optimizer step moves the MaskGit and critic parameters. Every random draw
of the loss and of the milestone samples comes from one CPU generator
seeded by `seed`.

As `jax.value_and_grad` does, every parameter gets a gradient each step,
zeros where the loss did not reach it, so Adam's moments and weight decay
move every parameter every step. `only_train_critic` zeroes the MaskGit's
gradients and `only_train_generator` a TokenCritic's, as the TPU step does;
a SelfCritic shares the MaskGit's trunk, and nothing is zeroed for it.

Milestones: after outer step s with (s - 1) % save_and_sample_every == 0
(step 1 first), milestone m = (s - 1) // save_and_sample_every samples,
with a generator seeded by a number drawn from the trainer's,
`num_samples` videos in groups of at most `batch_size` (captions drawn from
`sample_texts`) into `results_folder/videos.{m}/{caption}.gif`, or in image
mode one PNG grid `results_folder/{m}.png`, then saves a checkpoint
(`results_folder/checkpoints/{m}.pt`): the parameters, Adam's state, the
generator's state and the step count, all a resume needs to continue
bit-identically (gradients are accumulated within a step, so no
accumulation state outlives it; as in the TPU package, the data order is
not saved). `profile_dir` captures steps [profile_steps) with
`torch.profiler` into a Chrome trace there; a step shows as the spans
`phenaki.train_data` (the loader's batch onto the device),
`phenaki.train_loss_backward`, `phenaki.train_optimizer` (the gradients
completed and averaged, Adam, zeroing) and, when due,
`phenaki.train_milestone`.

On a mesh (`mesh=`, a `parallel.mesh.Mesh`; JAX `phenaki_trainer.py:128-131,
172-264`) every rank of it builds the trainer with the same arguments and
calls the same steps. `batch_size` is the global batch: each data-parallel
rank loads its shard of batch_size / dp rows (`DataLoader(num_shards=,
shard_id=)`) and takes its share of the global batch's loss
(`Phenaki.loss(dp_group=)`), so the ranks' gradients average to the one
process's; the average is one all-reduce a step (`collectives.
all_reduce_grads`). tp > 1 trains this rank's tensor-parallel clone of the
MaskGit and critic (`Phenaki.tp_shard(shard_head=True)`), whose attention
and FF blocks all-reduce their outputs; each tp rank holds its V / tp rows
of the MaskGit's vocab head (and Adam's moments of them), as JAX's rules
place `to_logits`, and the loss gathers the whole head once a step for the
fused CE. `fsdp=True` shards the trunks over the data group
(`parallel.fsdp.apply_fsdp`, on each `TransformerLayer` and on the MaskGit
and a TokenCritic), JAX's ZeRO-3 placement; FSDP then averages the sharded
gradients. `pp > 1` (or a mesh with a 'pp' axis; `make_mesh(pp=pp)` when no
mesh is given) trains this rank's pipeline stage (`Phenaki.pipeline_shard`):
its own trunk layers, tp-local with tp > 1, and the rest of the MaskGit
whole; the loss runs the trunks on GPipe's schedule in
`pipeline_microbatches` microbatches of the global batch
(`parallel.pipeline`), every rank of a stage's data-parallel row gets the
same batch, and the gradients of what every stage holds arrive whole on
every stage, so only the data group averages them. With `fsdp=True` as well
(dp x pp, JAX's placement of a pipelined, fully sharded tree) FSDP shards
the stage's clone over the stage's data group: its layers are gathered once
a step and kept through the backward, then freed before the optimizer's
step. A sharded trainer trains copies and
leaves the given Phenaki as it was; the trainer of a rank other than 0
keeps no reference to it. Every rank draws the same numbers from
`seed`. A milestone's samples come from rank 0 alone, from the given
Phenaki loaded with the consolidated parameters, with a generator seeded
from the trainer's; its checkpoint holds the consolidated (global) state,
the stages' layers gathered and Adam's state in the whole model's order,
written by rank 0, and loads on any mesh
(`training.checkpoint.consolidate`).
"""

from __future__ import annotations

import copy
import math
from functools import partial
from pathlib import Path
from random import choices
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from phenaki_tpu_torch.data.codecs import video_tensor_to_gif
from phenaki_tpu_torch.data.datasets import (
    DataLoader,
    ImageDataset,
    VideoDataset,
    collate_tensors_and_strings,
)
from phenaki_tpu_torch.models.maskgit import SelfCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.models.transformer import TransformerLayer
from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.fsdp import apply_fsdp, reshard
from phenaki_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh, make_mesh
from phenaki_tpu_torch.parallel.tp_inference import VocabShardedHead, clone_module, is_tp_sharded
from phenaki_tpu_torch.training.checkpoint import (
    CheckpointManager,
    consolidate,
    consolidate_optimizer,
    load_sharded,
    optimizer_groups,
    shard_optimizer_state,
)
from phenaki_tpu_torch.training.optimizer import get_optimizer, global_grad_norm, param_groups
from phenaki_tpu_torch.utils.image_grid import save_image_grid
from phenaki_tpu_torch.utils.logging import span, start_trace, stop_trace
from phenaki_tpu_torch.utils.results_folder import prepare_results_folder

VALID_FIELDS = {"videos", "texts", "video_codebook_ids", "video_frame_mask", "text_embeds"}
# the TPU package's loader decodes a batch's items on 4 threads
LOADER_WORKERS = 4


def check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")


def trainable_copy(phenaki: Phenaki, mesh) -> Phenaki:
    """The Phenaki a sharded trainer trains: this rank's tensor-parallel
    clone with its rows of the vocab head (tp > 1), else copies of the
    MaskGit and critic; the C-ViViT shared."""
    if mesh.tp > 1:
        return phenaki.tp_shard(mesh, shard_head=True)
    local = copy.copy(phenaki)
    local.maskgit = clone_module(phenaki.maskgit)
    if phenaki.self_token_critic:
        local.critic = SelfCritic(local.maskgit)
        local.critic.to_pred = clone_module(phenaki.critic.to_pred)
    elif phenaki.critic is not None:
        local.critic = clone_module(phenaki.critic)
    local._mesh_views = {}
    return local


def check_pipeline(phenaki: Phenaki, mesh: Mesh) -> None:
    """The JAX trainer's conditions on a pipeline mesh, as ValueErrors."""
    depth = phenaki.maskgit.transformer.depth
    if depth % mesh.pp:
        raise ValueError(f"the MaskGit's depth ({depth}) does not divide by pp ({mesh.pp})")
    heads = phenaki.maskgit.transformer.layers[0].self_attn.heads
    if heads % mesh.tp:
        raise ValueError(f"the MaskGit's heads ({heads}) do not divide by tp ({mesh.tp})")


def _named_trained(phenaki: Phenaki) -> List[Tuple[str, torch.nn.Parameter]]:
    """The MaskGit's and critic's parameters by qualified name ("maskgit.*",
    "critic.*"), in the order of `Phenaki.parameters`."""
    named = [(f"maskgit.{n}", p) for n, p in phenaki.maskgit.named_parameters()]
    if phenaki.critic is not None:
        named += [(f"critic.{n}", p) for n, p in phenaki.critic.named_parameters()]
    return named


def global_shapes(phenaki: Phenaki) -> dict:
    """The whole Phenaki's MaskGit and critic tensors' shapes by qualified name."""
    shapes = {f"maskgit.{k}": v.shape for k, v in phenaki.maskgit.state_dict().items()}
    if phenaki.critic is not None:
        shapes.update({f"critic.{k}": v.shape for k, v in phenaki.critic.state_dict().items()})
    return shapes


def dense_groups(phenaki: Phenaki, wd: float) -> List[List[str]]:
    """The names of the whole Phenaki's optimizer's parameter groups, the
    order its (and a checkpoint's) state follows."""
    named = _named_trained(phenaki)
    name_of = {id(p): n for n, p in named}
    return [[name_of[id(p)] for p in group] for group in param_groups([p for _, p in named if p.requires_grad], wd)]


def num_to_groups(num: int, divisor: int) -> List[int]:
    groups, rem = divmod(num, divisor)
    return [divisor] * groups + ([rem] if rem > 0 else [])


def simple_slugify(text: str, max_length: int = 255) -> str:
    return (text.replace("-", "_").replace(",", "").replace(" ", "_").replace("|", "--")
            .strip("-_")[:max_length])


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


def collate_and_cast(data: List[Any], dtype: torch.dtype) -> Tuple:
    """The string-aware collate, then float pixel fields (ndim >= 4) as
    tensors of `dtype`, the C-ViViT's (the host-to-device copy then moves
    that dtype's bytes)."""
    out = []
    for el in collate_tensors_and_strings(data):
        if isinstance(el, np.ndarray) and np.issubdtype(el.dtype, np.floating) and el.ndim >= 4:
            el = torch.from_numpy(el)
        if isinstance(el, torch.Tensor) and el.is_floating_point() and el.ndim >= 4:
            el = el.to(dtype)
        out.append(el)
    return tuple(out)


class PhenakiTrainer:
    def __init__(self, phenaki: Phenaki, *, folder: Optional[str] = None, train_on_images: bool = False,
                 batch_size: int = 16, grad_accum_every: int = 1, num_frames: int = 17,
                 sample_num_frames: Optional[int] = None, train_lr: float = 1e-4,
                 train_num_steps: int = 100000, max_grad_norm: Optional[float] = None,
                 adam_betas: Tuple[float, float] = (0.9, 0.99), wd: float = 0.0,
                 save_and_sample_every: int = 1000, num_samples: int = 25,
                 results_folder: str = "./results", clear_previous_results: Optional[bool] = None,
                 sample_texts_file_path: Optional[str] = None, sample_texts: Optional[List[str]] = None,
                 dataset=None, dataset_fields: Optional[Tuple[str, ...]] = None, mesh=None,
                 fsdp: bool = False, pp: int = 1, pipeline_microbatches: Optional[int] = None,
                 seed: int = 42, log_every: int = 10, profile_dir: Optional[str] = None,
                 profile_steps: Tuple[int, int] = (2, 4)):
        check_mesh(mesh)
        if phenaki.tp_mesh is not None or phenaki.pipeline_mesh is not None:
            raise ValueError("give the trainer the whole Phenaki: it shards it over `mesh` itself")
        if mesh is not None and PIPE_AXIS in mesh.shape and pp not in (1, mesh.pp):
            raise ValueError(f"pp ({pp}) differs from the mesh's ({mesh.pp})")
        if (fsdp or pp > 1) and mesh is None:
            mesh = make_mesh(pp=pp)
        pp = mesh.pp if mesh is not None else 1
        if pipeline_microbatches is not None and pp == 1:
            raise ValueError("pipeline_microbatches needs pp > 1 (or a mesh with a 'pp' axis)")
        if pp > 1:
            check_pipeline(phenaki, mesh)
        if math.isqrt(num_samples) ** 2 != num_samples:
            raise ValueError("number of samples must have an integer square root")
        if dataset_fields is not None and (len(set(dataset_fields)) != len(dataset_fields)
                                           or not set(dataset_fields) <= VALID_FIELDS):
            raise ValueError(f"dataset_fields {dataset_fields} must be distinct names in {VALID_FIELDS}")
        self.mesh = mesh
        dp = mesh.data_size if mesh is not None else 1
        if batch_size % dp:
            raise ValueError(f"the global batch ({batch_size}) must divide by the mesh's data axes ({dp})")
        self.dp_group = mesh.data_group if mesh is not None else None
        self.is_main = mesh is None or mesh.rank == 0
        # a sharded trainer trains copies; rank 0's given Phenaki samples the
        # milestones, and the other ranks keep none of it (a pipeline stage's
        # rank holds only its own trunk layers)
        self.sharded = mesh is not None and (fsdp or mesh.tp > 1 or pp > 1)
        if pp > 1:
            self.model = phenaki.pipeline_shard(mesh, pipeline_microbatches, shard_head=mesh.tp > 1)
        else:
            self.model = trainable_copy(phenaki, mesh) if self.sharded else phenaki
        # a checkpoint's layout: the whole model's shapes and optimizer groups
        self.global_shapes = global_shapes(phenaki)
        self.dense_groups = dense_groups(phenaki, wd)
        self.dense_model = phenaki if self.is_main or not self.sharded else None
        # the parameters FSDP leaves replicated, whose gradients are averaged here
        self.fsdp = bool(fsdp and mesh.data_size > 1)
        self.fsdp_ignored: List[torch.nn.Parameter] = []
        if self.fsdp:
            self.fsdp_ignored = apply_fsdp(self.model.maskgit, mesh, (TransformerLayer,))
            if phenaki.self_token_critic:  # its trunk is the MaskGit; its head replicated
                self.fsdp_ignored += list(self.model.critic.parameters())
            elif self.model.critic is not None:
                self.fsdp_ignored += apply_fsdp(self.model.critic, mesh, (TransformerLayer,))
        self.unconditional = phenaki.maskgit.unconditional
        self.sample_texts = None
        if sample_texts_file_path is not None:
            self.sample_texts = [t for t in Path(sample_texts_file_path).read_text().split("\n") if t]
        elif sample_texts is not None:
            self.sample_texts = list(sample_texts)
        if not self.unconditional and not self.sample_texts:
            raise ValueError("sample_texts or sample_texts_file_path must be given for "
                             "text-conditioned training")

        self.dataset_fields = dataset_fields
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.train_num_steps = train_num_steps
        self.train_on_images = train_on_images
        self.sample_num_frames = sample_num_frames if sample_num_frames is not None else num_frames
        self.num_samples = num_samples
        self.save_and_sample_every = save_and_sample_every
        self.log_every = log_every
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._trace = None
        self.step = 0
        self.generator = torch.Generator().manual_seed(seed)

        image_size = phenaki.cvivit.image_hw
        if dataset is not None:
            self.ds = dataset
        elif train_on_images:
            if folder is None:
                raise ValueError("train_on_images needs a folder of images or a dataset")
            self.ds = ImageDataset(folder, image_size)
        elif folder is not None:
            self.ds = VideoDataset(folder, image_size, num_frames=num_frames)
        else:
            self.ds = None
        self.dl: Optional[Iterator] = None
        if self.ds is not None:
            # on the card, batches come in page-locked memory, so that their
            # copies to the device are DMA transfers issued without a wait
            on_card = phenaki.maskgit.to_logits.weight.device.type == "cuda"
            self.dl = iter(DataLoader(self.ds, batch_size=batch_size // dp, seed=seed + 1, repeat=True,
                                      num_workers=LOADER_WORKERS, pin_memory=on_card,
                                      num_shards=dp, shard_id=mesh.data_index if mesh is not None else 0,
                                      collate_fn=partial(collate_and_cast, dtype=phenaki.cvivit.dtype)))

        named = self._named_params()
        stage_owned = self._stage_owned()
        heads = {f"maskgit.to_logits.{n}" for n, _ in self.model.maskgit.to_logits.named_parameters()
                 } if isinstance(self.model.maskgit.to_logits, VocabShardedHead) else set()
        tp_sharded = {n for n, _ in named if is_tp_sharded(n)} | heads
        grad_norm = (lambda: global_grad_norm(named, mesh, stage_owned, tp_sharded)) if mesh is not None else None
        self.opt = get_optimizer(self.model.parameters(), lr=train_lr, wd=wd, betas=adam_betas,
                                 max_grad_norm=max_grad_norm, grad_norm=grad_norm)
        self.results_folder = prepare_results_folder(results_folder, clear_previous_results)
        self.checkpoints = CheckpointManager(self.results_folder / "checkpoints")

    def _named_params(self) -> List[Tuple[str, torch.nn.Parameter]]:
        """The trained parameters by qualified name ("maskgit.*", "critic.*"),
        in the order of `Phenaki.parameters`, the optimizer's."""
        return _named_trained(self.model)

    def _stage_owned(self) -> set:
        """The names of the trained parameters that only this rank's pipeline
        stage holds: its trunk layers, where a trunk is split over stages."""
        owned = set()
        for prefix, module in (("maskgit.", self.model.maskgit), ("critic.", self.model.critic)):
            trunk = getattr(module, "transformer", None)
            if trunk is not None and trunk.stage is not None and len(trunk.stage) < trunk.depth:
                owned |= {prefix + n for n, _ in module.named_parameters() if n.startswith("transformer.layers.")}
        return owned

    def _optimizer_names(self) -> List[str]:
        return [n for g in optimizer_groups(self.opt, self._named_params()) for n in g]

    def data_tuple_to_fields(self, data: Tuple) -> Tuple[str, ...]:
        if self.dataset_fields is None:
            fields = determine_types(data)
            if len(set(fields)) != len(fields):
                raise ValueError(f"dataset fields {fields} are not distinct")
            self.dataset_fields = fields
        return self.dataset_fields

    def _device_batch(self, data: Tuple) -> dict:
        """A collated micro-batch -> `Phenaki.loss` keyword arguments on the
        MaskGit's device, texts embedded."""
        device = self.model.maskgit.to_logits.weight.device
        batch = {}
        for name, el in zip(self.data_tuple_to_fields(data), data):
            if name == "texts":
                batch["text_embeds"] = self.model.embed_texts(list(el))
            else:
                batch[name] = torch.as_tensor(el).to(device, non_blocking=True)
        if self.train_on_images and "videos" in batch and batch["videos"].ndim != 4:
            raise ValueError("you have it set to train on images, but the dataset is not returning "
                             "image batches")
        return batch

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

    def _maybe_profile(self, step: int) -> None:
        """Start the trace before step `profile_steps[0]`, stop it before
        step `profile_steps[1]`."""
        if not self.profile_dir:
            return
        start, stop = self.profile_steps
        if step == start:
            self._trace = start_trace()
        elif step == stop and self._trace is not None:
            stop_trace(self._trace, self.profile_dir)
            self._trace = None

    def train_step(self, only_train_generator: bool = False, only_train_critic: bool = False
                   ) -> torch.Tensor:
        """One optimizer step, then the milestone when one is due; returns the
        mean micro-batch loss as a device scalar (reading it on the host
        syncs with the card)."""
        if self.dl is None:
            raise ValueError("no dataset configured")
        self._maybe_profile(self.step)
        total = 0.0
        for _ in range(self.grad_accum_every):
            with span("phenaki.train_data"):
                batch = self._device_batch(next(self.dl))
            with span("phenaki.train_loss_backward"):
                loss, _ = self.model.loss(**batch, only_train_generator=only_train_generator,
                                          only_train_critic=only_train_critic, generator=self.generator,
                                          dp_group=self.dp_group)
                (loss / self.grad_accum_every).backward()
                total = total + loss.detach() / self.grad_accum_every
        with span("phenaki.train_optimizer"):
            if self.fsdp and self.mesh.pp > 1:  # the stages' layers were kept gathered through the backward
                for part in (self.model.maskgit, self.model.critic):
                    if part is not None:
                        reshard(part, (TransformerLayer,))
            self._complete_grads(only_train_generator, only_train_critic)
            if self.dp_group is not None:
                # FSDP averaged its shards' gradients; the rest are averaged here
                collectives.all_reduce_grads(self.fsdp_ignored if self.fsdp else self.model.parameters(),
                                             self.dp_group)
                total = collectives.all_reduce(total, self.dp_group) / collectives.group_size(self.dp_group)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        self.step += 1
        if self.step % self.log_every == 0 and self.is_main:
            print(f"{self.step}: loss: {float(total):.4f}")
        if (self.step - 1) % self.save_and_sample_every == 0:
            with span("phenaki.train_milestone"):
                self._sample_and_save((self.step - 1) // self.save_and_sample_every)
        return total

    def _sample_and_save(self, milestone: int) -> None:
        self._sample_artifacts(milestone)
        self.save(milestone)

    @staticmethod
    def _load_params(model: Phenaki, params: dict) -> None:
        model.maskgit.load_state_dict(params["maskgit"])
        if model.critic is not None:
            model.critic.load_state_dict(params["critic"])

    def _sample_artifacts(self, milestone: int) -> Optional[List[Optional[str]]]:
        """`num_samples` samples in groups of at most `batch_size`, written as
        GIFs named by their captions (a caption drawn twice keeps its last
        sample, as in the TPU package), or in image mode as one PNG grid;
        returns the captions drawn (None for an unconditional model). The
        samples draw from a generator seeded by a number drawn from the
        trainer's, which every rank draws alike. On a mesh every rank calls
        it and rank 0 alone samples, from the given Phenaki, into which a
        sharded trainer first loads the consolidated parameters (the other
        ranks return None)."""
        generator = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=self.generator)))
        if self.sharded:
            params = self._ckpt_tree(with_optimizer=False)["params"]
            if self.is_main:
                self._load_params(self.dense_model, params)
        if not self.is_main:
            return None
        model = self.dense_model
        texts = (choices(self.sample_texts, k=self.num_samples) if not self.unconditional
                 else [None] * self.num_samples)
        sampled, start = [], 0
        for group_size in num_to_groups(self.num_samples, self.batch_size):
            group = texts[start: start + group_size]
            start += group_size
            kwargs = {"batch_size": group_size} if self.unconditional else {"texts": list(group)}
            if self.train_on_images:
                out = model.sample_images(generator=generator, **kwargs)
            else:
                out = model.sample(num_frames=self.sample_num_frames, generator=generator, **kwargs)
            sampled.append(out.float().cpu().numpy())
        sampled = np.concatenate(sampled, axis=0)

        if self.train_on_images:
            save_image_grid(np.clip(sampled, 0.0, 1.0), str(self.results_folder / f"{milestone}.png"),
                            nrow=math.isqrt(self.num_samples))
            return texts
        folder = self.results_folder / f"videos.{milestone}"
        folder.mkdir(parents=True, exist_ok=True)
        for ind, video in enumerate(sampled):
            caption = texts[ind]
            slug = simple_slugify(caption) if caption is not None else str(ind)
            video_tensor_to_gif(video, str(folder / f"{slug}.gif"))
        return texts

    def _ckpt_tree(self, with_optimizer: bool = True) -> dict:
        """Everything a bit-identical resume needs: the parameters, Adam's
        state, the generator's state and the outer step count; on a mesh the
        global (consolidated) state, collectively."""
        if not self.sharded:
            params = {"maskgit": self.model.maskgit.state_dict()}
            if self.model.critic is not None:
                params["critic"] = self.model.critic.state_dict()
            opt_state = self.opt.state_dict()
        else:
            shapes = self.global_shapes
            params = {"maskgit": self._strip("maskgit.", consolidate(
                {f"maskgit.{k}": v for k, v in self.model.maskgit.state_dict().items()}, self.mesh, shapes))}
            if self.model.critic is not None:
                params["critic"] = self._strip("critic.", consolidate(
                    {f"critic.{k}": v for k, v in self.model.critic.state_dict().items()}, self.mesh, shapes))
            opt_state = consolidate_optimizer(self.opt, self._optimizer_names(), self.mesh, shapes,
                                              self.dense_groups) if with_optimizer else None
        return {"params": params, "opt_state": opt_state,
                "generator": self.generator.get_state(), "step": self.step}

    @staticmethod
    def _strip(prefix: str, tree: dict) -> dict:
        return {k[len(prefix):]: v for k, v in tree.items()}

    def save(self, milestone: int) -> None:
        """Write checkpoint `milestone` (on a mesh: every rank calls it, rank 0
        writes the consolidated state)."""
        tree = self._ckpt_tree()
        if self.is_main:
            self.checkpoints.save(milestone, tree)
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()  # the file is whole before any rank goes on (and may load it)

    def load(self, milestone: Optional[int] = None) -> None:
        """Restore a checkpoint `save` wrote (the latest when None) into this
        trainer, whose model has the same global shapes; on a mesh every rank
        reads it and keeps its shard."""
        restored = self.checkpoints.restore(milestone)
        params = restored["params"]
        if ("critic" in params) != (self.model.critic is not None):
            raise ValueError("the checkpoint and this trainer's model differ in having a critic")
        if not self.sharded:
            self._load_params(self.model, params)
            self.opt.load_state_dict(restored["opt_state"])
        else:
            load_sharded(self.model.maskgit.state_dict(), params["maskgit"], self.mesh)
            if self.model.critic is not None:
                load_sharded(self.model.critic.state_dict(), params["critic"], self.mesh)
            self.opt.load_state_dict(shard_optimizer_state(
                restored["opt_state"], self.opt, self._optimizer_names(), self.mesh,
                [n for g in self.dense_groups for n in g]))
        self.generator.set_state(restored["generator"])
        self.step = int(restored["step"])

    def train(self, only_train_generator: bool = False, only_train_critic: bool = False) -> None:
        while self.step < self.train_num_steps:
            self.train_step(only_train_generator=only_train_generator,
                            only_train_critic=only_train_critic)
        if self.is_main:
            print("training complete")
