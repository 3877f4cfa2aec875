"""C-ViViT (VQGAN) trainer (counterpart of
phenaki_tpu/training/cvivit_trainer.py).

Two optimizers, one step of each a `train_step()`:

* the generator phase: recon + perceptual + VQ aux + adaptive * gen loss
  (`models/cvivit_losses.cvivit_generator_loss`), gradients over the
  C-ViViT's parameters only (the discriminator's are frozen for the phase),
  an optimizer step, then the EMA of the C-ViViT's parameters;
* the discriminator phase: hinge (or BCE) on one random frame a video, real
  against the reconstruction, and on every `apply_grad_penalty_every`-th
  step (step 0 first) the R1 gradient penalty; gradients over the
  discriminator's parameters only.

Each phase runs `grad_accum_every` micro-batches, averages their gradients
as `optax.MultiSteps` does and steps its optimizer once; every parameter
gets a gradient, zeros where the loss did not reach it, as with
`jax.value_and_grad`. The C-ViViT runs with dropout off (the TPU trainer's
`deterministic=True`); a cosine VQ's codebook EMA moves in the generator
phase. The trainer takes the C-ViViT on its device with its weights, and
builds the discriminator there from `seed` (and, for `perceptual_mode="vgg"`,
the VGG16 from seed 0, or from `vgg_params`, or from the torchvision file
named by PHENAKI_VGG16_PATH), computing in the C-ViViT's dtype. Every random
draw (the judged frames) comes from one CPU generator seeded by `seed`.

Data: a `dataset=` of videos (or of tuples whose first field is the
video), or a `folder=` of GIF/MP4 videos (`VideoDataset`) or, with
`train_on_images`, of images (`ImageDataset`), split by `valid_frac`, and
loaded as `PhenakiTrainer` loads (`LOADER_WORKERS` worker processes that
decode, collate and cast to the C-ViViT's dtype; pinned on the card).

After step s (counting from 0), when s % save_results_every == 0 a
validation batch is reconstructed with the EMA and the raw parameters, as
GIFs under `results_folder/samples.{s}[.ema]/`, or for images as a PNG grid
of originals and reconstructions interleaved, `{s}[.ema].png`; when
s % save_model_every == 0 a checkpoint `results_folder/checkpoints/{s}.pt`
holds both models, both optimizers' state, the EMA, the generator's state
and the step, so that a resume continues bit-identically (as in the TPU
package, the data order is not saved). `profile_dir` captures steps
[profile_steps) with `torch.profiler`.

On a mesh (`mesh=`, JAX `cvivit_trainer.py:116-117, 207-238, 495-515`)
every rank builds the trainer alike and calls the same steps; `batch_size`
is the global batch, of which each data-parallel rank loads its
interleaved shard (`DataLoader(num_shards=, shard_id=)`) and takes its
share of the losses (`dp_group=` of the loss functions; the quantizer's
batch statistics over the group, a VQ's EMA statistics all-reduced and so
replicated, as JAX replicates `vq_stats`). Gradients are averaged over the
data group: the discriminator and the VGG are data-parallel. tp > 1 trains
the rank's tensor-parallel clone of the C-ViViT's transformers
(`parallel.tp_inference.tp_local_module`); `fsdp=True` shards its
transformer layers and the C-ViViT itself over the data group, the pixel
heads (the adaptive weight's) kept replicated. Both Adams and the EMA hold
tensors of the parameters' placement. The validation reconstructions run on
every rank (the same batch) and rank 0 writes them; checkpoints hold the
consolidated state, written by rank 0, and load on any mesh. A sharded
trainer trains a copy of the C-ViViT.
"""

from __future__ import annotations

import contextlib
import os
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from phenaki_tpu_torch.data.codecs import video_tensor_to_gif
from phenaki_tpu_torch.data.datasets import DataLoader, ImageDataset, VideoDataset, random_split
from phenaki_tpu_torch.models.cvivit import CViViT, Discriminator
from phenaki_tpu_torch.models.cvivit_losses import cvivit_discriminator_loss, cvivit_generator_loss
from phenaki_tpu_torch.models.vgg import init_vgg, load_vgg16_from_file
from phenaki_tpu_torch.models.transformer import TransformerLayer
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.fsdp import apply_fsdp
from phenaki_tpu_torch.parallel.mesh import make_mesh, place_like
from phenaki_tpu_torch.parallel.tp_inference import clone_module, tp_local_module
from phenaki_tpu_torch.models.cvivit_losses import _pixel_head_params
from phenaki_tpu_torch.training.checkpoint import (
    CheckpointManager,
    consolidate,
    consolidate_optimizer,
    load_sharded,
    optimizer_groups,
    shard_optimizer_state,
)
from phenaki_tpu_torch.training.ema import EMAState, ema_init, ema_update
from phenaki_tpu_torch.training.optimizer import get_optimizer, global_grad_norm
from phenaki_tpu_torch.training.phenaki_trainer import LOADER_WORKERS, check_mesh, collate_and_cast
from phenaki_tpu_torch.utils.image_grid import save_image_grid
from phenaki_tpu_torch.utils.logging import MetricLogger, accum_log, start_trace, stop_trace
from phenaki_tpu_torch.utils.results_folder import prepare_results_folder

GEN_METRICS = ("loss", "recon_loss", "vq_aux_loss")
GAN_METRICS = ("perceptual_loss", "gen_loss", "adaptive_weight")


def _complete_grads(module: torch.nn.Module) -> None:
    """Zeros for every parameter the loss did not reach."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class CViViTTrainer:
    def __init__(self, vae: CViViT, *, num_train_steps: int, batch_size: int,
                 folder: Optional[str] = None, dataset=None, train_on_images: bool = False,
                 num_frames: int = 17, lr: float = 3e-4, grad_accum_every: int = 1, wd: float = 0.0,
                 max_grad_norm: Optional[float] = 0.5, discr_max_grad_norm: Optional[float] = None,
                 save_results_every: int = 100, save_model_every: int = 1000,
                 results_folder: str = "./results", clear_previous_results: Optional[bool] = None,
                 valid_frac: float = 0.05, random_split_seed: int = 42, use_ema: bool = True,
                 ema_beta: float = 0.995, ema_update_after_step: int = 0, ema_update_every: int = 1,
                 apply_grad_penalty_every: int = 4, use_vgg_and_gan: bool = True,
                 use_hinge_loss: bool = True, perceptual_mode: str = "disc", discr_base_dim: int = 16,
                 discr_attn_res_layers: tuple = (16,), vgg_params: Optional[Dict] = None, mesh=None,
                 fsdp: bool = False, seed: int = 42, log_every: int = 10,
                 profile_dir: Optional[str] = None, profile_steps: Tuple[int, int] = (2, 4)):
        check_mesh(mesh)
        if fsdp and mesh is None:
            mesh = make_mesh()
        dp = mesh.data_size if mesh is not None else 1
        if batch_size % dp:
            raise ValueError(f"the global batch ({batch_size}) must divide by the mesh's data axes ({dp})")
        self.mesh = mesh
        self.dp_group = mesh.data_group if mesh is not None else None
        self.is_main = mesh is None or mesh.rank == 0
        self.sharded = mesh is not None and (fsdp or mesh.tp > 1)
        self.dense_vae = vae
        if self.sharded:
            vae = (tp_local_module(vae, mesh.tp, mesh.tp_group) if mesh.tp > 1 else clone_module(vae))
        vae.vq.batch_group = self.dp_group
        self.fsdp = bool(fsdp and dp > 1)
        self.fsdp_ignored = (apply_fsdp(vae, mesh, (TransformerLayer,), keep_replicated=_pixel_head_params(vae),
                                        forward_methods=("forward_intermediates",))
                             if self.fsdp else [])
        if perceptual_mode not in ("vgg", "disc", "none"):
            raise ValueError(f"perceptual_mode {perceptual_mode!r} is not one of vgg, disc, none")
        if vgg_params is None and perceptual_mode == "vgg":
            # gated on an explicit "vgg", so that the variable alone never
            # overrides the "disc" default
            vgg_path = os.environ.get("PHENAKI_VGG16_PATH")
            if vgg_path and os.path.isfile(vgg_path):
                vgg_params = load_vgg16_from_file(vgg_path)
        if vgg_params is not None:
            perceptual_mode = "vgg"  # given weights win
        self.vae = vae.train(False)
        self.perceptual_mode = perceptual_mode
        self.use_vgg_and_gan = use_vgg_and_gan
        self.use_hinge_loss = use_hinge_loss
        self.num_train_steps = num_train_steps
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.apply_grad_penalty_every = apply_grad_penalty_every
        self.use_ema = use_ema
        self.ema_beta = ema_beta
        self.ema_update_after_step = ema_update_after_step
        self.ema_update_every = ema_update_every
        self.train_on_images = train_on_images
        self.log_every = log_every
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._trace = None
        self.logger = MetricLogger()
        self.step = 0
        self.generator = torch.Generator().manual_seed(seed)

        self.device = device = vae.to_pixels_first.weight.device
        self.discr = self.vgg = None
        if use_vgg_and_gan:
            self.discr = Discriminator(dim=discr_base_dim, image_size=vae.image_hw, channels=vae.channels,
                                       attn_res_layers=discr_attn_res_layers, dtype=vae.dtype)
            init_parameters(self.discr, torch.Generator().manual_seed(seed))
            self.discr.to(device)
            if perceptual_mode == "vgg":
                self.vgg = init_vgg(0, device=device, dtype=vae.dtype).requires_grad_(False)
                if vgg_params is not None:
                    self.vgg.load_state_dict(vgg_params)

        named = list(vae.named_parameters())
        grad_norm = (lambda: global_grad_norm(named, mesh)) if mesh is not None else None
        self.gen_opt = get_optimizer(vae.parameters(), lr=lr, wd=wd, max_grad_norm=max_grad_norm,
                                     grad_norm=grad_norm)
        self.discr_opt = (get_optimizer(self.discr.parameters(), lr=lr, wd=wd,
                                        max_grad_norm=discr_max_grad_norm) if self.discr else None)
        self.ema: Optional[EMAState] = ema_init(dict(vae.named_parameters())) if use_ema else None

        self.dl = self.valid_dl = None
        if dataset is not None or folder is not None:
            if dataset is not None:
                self.ds = dataset
            elif train_on_images:
                self.ds = ImageDataset(folder, vae.image_hw)
            else:
                self.ds = VideoDataset(folder, vae.image_hw, channels=vae.channels, num_frames=num_frames)
            if valid_frac > 0:
                self.ds, self.valid_ds = random_split(self.ds, valid_frac, seed=random_split_seed)
                print(f"training with dataset of {len(self.ds)} samples and validating with randomly "
                      f"splitted {len(self.valid_ds)} samples")
            else:
                self.valid_ds = self.ds
                print(f"training with shared training and valid dataset of {len(self.ds)} samples")
            collate = partial(collate_and_cast, dtype=vae.dtype)
            # on the card, batches come in page-locked memory, so that their
            # copies to the device are DMA transfers issued without a wait
            self.dl = iter(DataLoader(self.ds, batch_size=batch_size // dp, seed=seed + 1, repeat=True,
                                      num_workers=LOADER_WORKERS, pin_memory=device.type == "cuda",
                                      num_shards=dp, shard_id=mesh.data_index if mesh is not None else 0,
                                      collate_fn=collate))
            self.valid_dl = iter(DataLoader(self.valid_ds, batch_size=batch_size, seed=seed + 2,
                                            repeat=True, collate_fn=collate))

        self.results_folder = prepare_results_folder(results_folder, clear_previous_results)
        self.checkpoints = CheckpointManager(self.results_folder / "checkpoints")

    def _next_batch(self, it) -> torch.Tensor:
        (batch, *_rest) = next(it)
        batch = torch.as_tensor(batch).to(self.device, non_blocking=True)
        if self.train_on_images and batch.ndim != 4:
            raise ValueError("you have it set to train on images, but the dataset is not returning "
                             "image batches")
        return batch

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

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One generator and one discriminator step; returns the mean
        micro-batch losses as device scalars (reading one syncs with the
        card)."""
        if self.dl is None:
            raise ValueError("no dataset configured")
        steps = self.step
        self._maybe_profile(steps)
        k = self.grad_accum_every
        logs: Dict[str, torch.Tensor] = {}

        # generator phase
        if self.discr is not None:
            self.discr.requires_grad_(False)
        names = GEN_METRICS + (GAN_METRICS if self.use_vgg_and_gan else ())
        for _ in range(k):
            loss, aux = cvivit_generator_loss(
                self.vae, self._next_batch(self.dl), generator=self.generator, discr=self.discr,
                vgg=self.vgg, use_vgg_and_gan=self.use_vgg_and_gan, use_hinge_loss=self.use_hinge_loss,
                update_codebook=not self.vae.lookup_free_quantization,
                perceptual_mode=self.perceptual_mode, dp_group=self.dp_group)
            (loss / k).backward()
            accum_log(logs, {name: aux[name].detach() / k for name in names})
        _complete_grads(self.vae)
        collectives.all_reduce_grads(self.fsdp_ignored if self.fsdp else self.vae.parameters(),
                                     self.dp_group)
        self.gen_opt.step()
        self.gen_opt.zero_grad(set_to_none=True)
        if self.ema is not None:
            self.ema = ema_update(self.ema, dict(self.vae.named_parameters()), decay=self.ema_beta,
                                  update_after_step=self.ema_update_after_step,
                                  update_every=self.ema_update_every)

        # discriminator phase
        if self.discr is not None:
            self.discr.requires_grad_(True)
            apply_gp = steps % self.apply_grad_penalty_every == 0
            for _ in range(k):
                loss, aux = cvivit_discriminator_loss(
                    self.vae, self.discr, self._next_batch(self.dl), generator=self.generator,
                    apply_grad_penalty=apply_gp, use_hinge_loss=self.use_hinge_loss,
                    dp_group=self.dp_group)
                (loss / k).backward()
                accum_log(logs, {name: aux[name].detach() / k for name in ("discr_loss", "grad_penalty")})
            _complete_grads(self.discr)
            collectives.all_reduce_grads(self.discr.parameters(), self.dp_group)
            self.discr_opt.step()
            self.discr_opt.zero_grad(set_to_none=True)
        logs = self._global_logs(logs)
        if self.discr is not None:
            if steps % self.log_every == 0 and self.is_main:
                print(f"{steps}: vae loss: {float(logs['loss']):.4f} - "
                      f"discr loss: {float(logs['discr_loss']):.4f}")
        elif steps % self.log_every == 0 and self.is_main:
            print(f"{steps}: vae loss: {float(logs['loss']):.4f}")

        if steps % self.save_results_every == 0:
            self._save_results(steps)
        if steps % self.save_model_every == 0:
            self.save(steps)
        self.step += 1
        self.logger.log(steps, logs)
        return logs

    def _global_logs(self, logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The losses averaged over the data group (one all-reduce)."""
        if self.dp_group is None:
            return logs
        names = list(logs)
        mean = collectives.all_reduce(torch.stack([logs[n].float() for n in names]), self.dp_group)
        mean = mean / collectives.group_size(self.dp_group)
        return {n: mean[i] for i, n in enumerate(names)}

    @contextlib.contextmanager
    def _with_params(self, params: Dict[str, torch.Tensor]):
        """The C-ViViT with `params` in place of its own for the block; FSDP
        keeps its own parameter objects, so the values are swapped."""
        own = dict(self.vae.named_parameters())
        saved = {n: own[n].detach().clone() for n in params}
        with torch.no_grad():
            for n, v in params.items():
                own[n].copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for n, v in saved.items():
                    own[n].copy_(v)

    def _reconstruct(self, batch: torch.Tensor, use_ema: bool) -> torch.Tensor:
        if not use_ema:
            return self.vae(batch)[0]
        if not self.fsdp:
            return functional_call(self.vae, self.ema.params, (batch,))[0]
        with self._with_params(self.ema.params):
            return self.vae(batch)[0]

    @torch.no_grad()
    def _save_results(self, steps: int) -> None:
        """Reconstructions of a validation batch with the EMA parameters and
        with the raw ones (on a mesh every rank reconstructs the same batch,
        rank 0 writes)."""
        if self.valid_dl is None:
            return
        valid_batch = self._next_batch(self.valid_dl)
        to_eval = [(False, str(steps))]
        if self.use_ema:
            to_eval.insert(0, (True, f"{steps}.ema"))
        for use_ema, filename in to_eval:
            recons = self._reconstruct(valid_batch, use_ema).float().cpu().numpy()
            if not self.is_main:
                continue
            if valid_batch.ndim == 5:
                folder = self.results_folder / f"samples.{filename}"
                folder.mkdir(parents=True, exist_ok=True)
                for i, video in enumerate(recons):
                    video_tensor_to_gif(video, str(folder / f"{filename}-{i}.gif"))
            else:
                originals = valid_batch.float().cpu().numpy()
                interleaved = np.stack([originals, recons], axis=1).reshape(-1, *recons.shape[1:])
                save_image_grid(np.clip(interleaved, 0.0, 1.0), str(self.results_folder / f"{filename}.png"),
                                nrow=2)
        if self.is_main:
            print(f"{steps}: saving to {self.results_folder}")

    def _ckpt_tree(self) -> dict:
        """Everything a bit-identical resume needs: both models (the VQ
        codebook with the C-ViViT), both optimizers' state, the EMA, the
        generator's state and the step; a sharded C-ViViT's, its optimizer's
        and its EMA's consolidated, collectively."""
        vae, gen_opt = self.vae.state_dict(), self.gen_opt.state_dict()
        ema = self.ema.params if self.ema is not None else None
        if self.sharded:
            shapes = {k: v.shape for k, v in self.dense_vae.state_dict().items()}
            vae = consolidate(vae, self.mesh, shapes)
            groups = optimizer_groups(self.gen_opt, self.vae.named_parameters())
            gen_opt = consolidate_optimizer(self.gen_opt, [n for g in groups for n in g], self.mesh, shapes, groups)
            ema = consolidate(ema, self.mesh, shapes) if ema is not None else None
        return {"vae": vae,
                "discr": self.discr.state_dict() if self.discr is not None else None,
                "gen_opt_state": gen_opt,
                "discr_opt_state": self.discr_opt.state_dict() if self.discr_opt is not None else None,
                "ema": dict(params=ema, step=self.ema.step) if self.ema is not None else None,
                "generator": self.generator.get_state(), "step": self.step}

    def save(self, milestone: int) -> None:
        """Write checkpoint `milestone` (on a mesh every rank calls it and rank
        0 writes)."""
        tree = self._ckpt_tree()
        if self.is_main:
            self.checkpoints.save(milestone, tree)
            print(f"{self.step}: saving model to {self.results_folder}")
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()  # the file is whole before any rank goes on (and may load it)

    @torch.no_grad()
    def load(self, milestone: Optional[int] = None) -> None:
        """Restore a checkpoint `save` wrote (the latest when None) into this
        trainer, whose models have the same shapes and options."""
        restored = self.checkpoints.restore(milestone)
        if (restored["discr"] is None) != (self.discr is None) or \
                (restored["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint and this trainer differ in having a discriminator or an EMA")
        if self.sharded:
            load_sharded(self.vae.state_dict(), restored["vae"], self.mesh)
            names = [n for g in optimizer_groups(self.gen_opt, self.vae.named_parameters()) for n in g]
            self.gen_opt.load_state_dict(shard_optimizer_state(restored["gen_opt_state"], self.gen_opt, names,
                                                               self.mesh, names))
        else:
            self.vae.load_state_dict(restored["vae"])
            self.gen_opt.load_state_dict(restored["gen_opt_state"])
        if self.discr is not None:
            self.discr.load_state_dict(restored["discr"])
            self.discr_opt.load_state_dict(restored["discr_opt_state"])
        if self.ema is not None:
            ema = restored["ema"]
            if sorted(ema["params"]) != sorted(self.ema.params):
                raise ValueError("the checkpoint's EMA holds other parameters")
            values = place_like(self.ema.params, ema["params"], self.mesh) if self.sharded else ema["params"]
            for name, t in self.ema.params.items():
                v = values[name]
                if hasattr(t, "to_local"):
                    t.to_local().copy_(v.to_local())
                else:
                    t.copy_(v)
            self.ema = EMAState(params=self.ema.params, step=int(ema["step"]))
        self.generator.set_state(restored["generator"])
        self.step = int(restored["step"])

    def train(self, log_fn=None) -> None:
        while self.step < self.num_train_steps:
            logs = self.train_step()
            if log_fn is not None:
                log_fn(logs)
        if self.is_main:
            print("training complete")
