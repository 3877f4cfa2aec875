"""Phenaki: text-to-video sampling, prime-frame continuation, long videos
and the MaskGit + critic training loss (counterpart of
phenaki_tpu/models/phenaki.py: `Phenaki.sample`, `sample_images`,
`make_video`, `Phenaki.loss` and its `__call__`, `save` and `load`).

A sample: the texts through the text encoder (`embed_texts`), or given
text embeddings, padded to `max_text_len` (text mask = rows that are not
all zero) -> the prime frames, if any, tokenized by the C-ViViT in eval
mode -> the MaskGit 3-D position bias over the primed patch grid, computed
once -> the 18-step decode loop over the scene's tokens with the prime ids
in front (CFG in embedding space, `to_logits` feeding the projection
sampler; with a critic, the critic's CFG-combined logits score the tokens
for the re-mask) -> C-ViViT decode of the prime and scene ids to video, the
prime's frames dropped. `make_video` chains scenes, each primed with the
last frames of the one before.

The loss: raw videos or images, where given, are tokenized by the frozen
C-ViViT (no gradient); a random step per sample gives the cosine mask
fraction, that many valid tokens are replaced by the mask id, and the
masked tokens' cross-entropy over the vocab is averaged. Where the fused
CE takes the shape (`can_fuse_ce`, the flagship's d = 512, V = 65,536
among them) the MaskGit returns its final embeddings and
`fused_vocab_cross_entropy` takes the CE with the `to_logits` projection,
so the (b, n, V) logits are never
materialised on the card; otherwise the logits are materialised and the CE
is plain torch in f32, as in the TPU package's non-fused branch. With a
critic (a TokenCritic, or the SelfCritic on the MaskGit's own trunk), the
generator's sample of every token (the projection sampler on the detached
embeddings under the fused CE, `gumbel_sample` on the f32 logits otherwise)
replaces the masked tokens, and the critic learns by sigmoid BCE which
tokens differ from the video's.

On a mesh (`parallel.mesh.Mesh`, JAX `phenaki.py:442-708`): `sample(mesh=)`
gives each data-parallel rank a contiguous shard of the global batch, drawn
from its own generator (`dp_generator`: seeded from the caller's generator
and the shard, as JAX folds the shard into the rng); the tensor-parallel
ranks of a shard share that generator and run the MaskGit and a TokenCritic
as their tp-local clones (`tp_shard`; a SelfCritic runs the local trunk with
its head replicated), so they draw the same ids; every rank returns the
global batch, gathered. Every rank of the mesh calls `sample` with the same
arguments. `loss(dp_group=)` is one data-parallel rank's share of the loss
of the global batch, whose rows the ranks' loaders interleave (rank r of n
holds rows r, r + n, ...): every random draw is made for the global batch
and the rank keeps its rows, and the masked-token mean divides by the global
count, so the ranks' losses (and gradients) average to the one-process
loss of the global batch. On the card the critic branch's sampler draws its
noise from a seed for the local rows, so only the CPU, which draws the
uniforms, holds that exactly with a critic. With `pipeline_mesh` set (a
mesh with a 'pp' axis, JAX `phenaki.py:110-114,308-311,385-397`) the loss
runs the MaskGit's trunk on GPipe's schedule in `pipeline_microbatches`
microbatches, and the critic's when its depth divides by pp (else it runs
whole on every rank); `pipeline_shard(mesh)` makes the rank's stage-local
Phenaki that does so. Sampling stays dense, as in the JAX package. A
trainer's tensor-parallel clone (`tp_shard(shard_head=True)`) holds a rank's
rows of the vocab head alone; its loss gathers the whole head once a call in
the compute dtype, which the fused CE and the critic branch's sampler read,
as GSPMD hands JAX's Pallas CE the gathered vocab-parallel head.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, SelfCritic, TokenCritic
from phenaki_tpu_torch.models.sampling_loop import maskgit_sample_loop
from phenaki_tpu_torch.ops.fused_ce import can_fuse_ce, fused_vocab_cross_entropy
from phenaki_tpu_torch.ops.fused_sampling import project_sample
from phenaki_tpu_torch.ops.sampling import (
    get_mask_subset_with_prob,
    gumbel_sample,
    prob_mask_like,
    uniform,
)
from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.pipeline import pipeline_stage_module
from phenaki_tpu_torch.parallel.tp_inference import VocabShardedHead, clone_module, tp_local_module
from phenaki_tpu_torch.text.t5 import DEFAULT_T5_NAME, get_encoded_dim, t5_encode_text
from phenaki_tpu_torch.training.checkpoint import load_pytree, save_pytree
from phenaki_tpu_torch.utils.logging import span


def dp_generator(generator: Optional[torch.Generator], shard: int, group=None) -> torch.Generator:
    """The generator data-parallel shard `shard` samples with: a CPU
    generator seeded from a number drawn from `generator` and the shard
    (without a generator, rank 0's random number, broadcast over `group`)."""
    seed = np.random.SeedSequence([collectives.shared_seed(generator, group), shard]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) % 2**63)


class Phenaki:
    def __init__(self, *, maskgit: MaskGit, cvivit: CViViT, t5_name: str = DEFAULT_T5_NAME,
                 text_embed_dim: Optional[int] = None, steps: int = 18, max_text_len: int = 128,
                 cond_drop_prob: float = 0.25,
                 critic: Optional[TokenCritic] = None, self_token_critic: bool = False,
                 critic_loss_weight: float = 1.0, critic_noise_anneal_schedule: str = "decay",
                 critic_train_sample_temperature: float = 1.0):
        """`critic` is a TokenCritic, with cross-attention exactly when the
        MaskGit is conditional; `self_token_critic` builds a SelfCritic on
        the MaskGit's trunk instead (its head `to_pred` drawn by torch's
        default init, on the MaskGit's device and dtype). `t5_name` picks
        the text encoder of `texts`; `text_embed_dim` defaults to its width."""
        if not cond_drop_prob > 0:
            raise ValueError("cond_drop_prob must be > 0")
        if self_token_critic and critic is not None:
            raise ValueError("give a critic or self_token_critic=True, not both")
        if critic is not None and (not maskgit.unconditional) != critic.has_cross_attn:
            raise ValueError("the critic has cross-attention exactly when the MaskGit is conditional")
        if self_token_critic:
            weight = maskgit.to_logits.weight
            critic = SelfCritic(maskgit).to(device=weight.device, dtype=weight.dtype)
        self.maskgit = maskgit
        self.cvivit = cvivit.eval()
        self.critic = critic
        self.self_token_critic = self_token_critic
        self.critic_loss_weight = critic_loss_weight
        self.critic_noise_anneal_schedule = critic_noise_anneal_schedule
        self.critic_train_sample_temperature = critic_train_sample_temperature
        self.steps = steps
        self.t5_name = t5_name
        self.text_embed_dim = text_embed_dim if text_embed_dim is not None else get_encoded_dim(t5_name)
        self.max_text_len = max_text_len
        self.cond_drop_prob = cond_drop_prob
        self.tp_mesh = None  # the mesh whose tp group the trunks are sharded over
        self._mesh_views: Dict[int, tuple] = {}
        # the mesh whose 'pp' axis the loss pipelines the trunks over (None: sequential)
        self.pipeline_mesh = None
        self.pipeline_microbatches: Optional[int] = None

    def tp_shard(self, mesh, shard_head: bool = False) -> "Phenaki":
        """This rank's tensor-parallel Phenaki over `mesh`'s tp group: the
        MaskGit and a TokenCritic as their tp-local clones
        (`parallel.tp_inference.tp_local_module`, copies), a SelfCritic on the
        local trunk with a copy of its head; the C-ViViT shared. `shard_head`
        (training) keeps the rank's rows of the MaskGit's vocab head alone;
        sampling keeps it whole. With tp = 1, or already sharded over `mesh`,
        itself."""
        if mesh.tp == 1 or self.tp_mesh is mesh:
            return self
        if self.tp_mesh is not None:
            raise ValueError("this Phenaki is tensor-parallel over another mesh already")
        local = copy.copy(self)
        local.maskgit = tp_local_module(self.maskgit, mesh.tp, mesh.tp_group, shard_head=shard_head)
        if self.self_token_critic:
            head = copy.deepcopy(self.critic.to_pred)
            local.critic = SelfCritic(local.maskgit)
            local.critic.to_pred = head
        elif self.critic is not None:
            local.critic = tp_local_module(self.critic, mesh.tp, mesh.tp_group)
        local.tp_mesh = mesh
        local._mesh_views = {}
        return local

    def pipeline_shard(self, mesh, microbatches: Optional[int] = None, shard_head: bool = False) -> "Phenaki":
        """This rank's pipeline-parallel Phenaki over `mesh` (which has a 'pp'
        axis): the MaskGit as its stage-local clone
        (`parallel.pipeline.pipeline_stage_module`, tp-local too when the
        mesh has tp > 1, its vocab head's rows alone with `shard_head`), a
        SelfCritic on that trunk with a copy of its head,
        a TokenCritic stage-local when its depth divides by pp and else
        whole (tp-local with tp > 1); the C-ViViT shared. Its loss pipelines
        in `microbatches` microbatches (the default of
        `pipeline_transformer_apply` when None)."""
        if self.tp_mesh is not None or self.pipeline_mesh is not None:
            raise ValueError("this Phenaki is sharded over a mesh already")
        local = copy.copy(self)
        local.maskgit = pipeline_stage_module(self.maskgit, mesh, shard_head=shard_head)
        if self.self_token_critic:
            local.critic = SelfCritic(local.maskgit)
            local.critic.to_pred = clone_module(self.critic.to_pred)
        elif self.critic is not None:
            if self.critic.transformer.depth % mesh.pp == 0:
                local.critic = pipeline_stage_module(self.critic, mesh)
            elif mesh.tp > 1:
                local.critic = tp_local_module(self.critic, mesh.tp, mesh.tp_group)
            else:
                local.critic = clone_module(self.critic)
        local.tp_mesh = mesh if mesh.tp > 1 else None
        local.pipeline_mesh, local.pipeline_microbatches = mesh, microbatches
        local._mesh_views = {}
        return local

    def _pipeline_kwargs(self, module, generator) -> dict:
        """The pipeline's arguments for the MaskGit or a TokenCritic: none
        without a pipeline mesh, or for a critic whose depth pp does not
        divide (it runs whole on every rank)."""
        if self.pipeline_mesh is None:
            return {}
        if module is not self.maskgit and module.transformer.depth % self.pipeline_mesh.pp:
            return {}
        return dict(pipeline_mesh=self.pipeline_mesh, pipeline_microbatches=self.pipeline_microbatches,
                    generator=generator)

    def _sampling_view(self, mesh) -> "Phenaki":
        """`tp_shard(mesh)`, kept while no parameter changed in place."""
        if mesh.tp == 1 or self.tp_mesh is mesh:
            return self
        version = tuple(p._version for p in self.parameters())
        held = self._mesh_views.get(id(mesh))
        if held is None or held[0] is not mesh or held[1] != version:
            held = (mesh, version, self.tp_shard(mesh))
            self._mesh_views = {id(mesh): held}
        return held[2]

    def parameters(self) -> Iterator[nn.Parameter]:
        """The trainable parameters: the MaskGit's, then the critic's (a
        SelfCritic's are its head's; its trunk is the MaskGit)."""
        yield from self.maskgit.parameters()
        if self.critic is not None:
            yield from self.critic.parameters()

    def pad_text_embeds(self, emb: torch.Tensor) -> torch.Tensor:
        """(b, L, d) -> (b, max_text_len, d), zero-padded or truncated."""
        b, L, d = emb.shape
        if d != self.text_embed_dim:
            raise ValueError(f"text embedding dim {d} != {self.text_embed_dim}")
        if L >= self.max_text_len:
            return emb[:, : self.max_text_len]
        return torch.cat([emb, emb.new_zeros(b, self.max_text_len - L, d)], dim=1)

    def embed_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """texts -> (b, max_text_len, d) f32 on the MaskGit's device,
        zero-padded, from the text encoder of `t5_name` (HF T5 on that
        device where its weights are on disk, else the offline hash encoder
        of width `text_embed_dim`)."""
        device = self.maskgit.to_logits.weight.device
        emb = t5_encode_text(texts, name=self.t5_name, fallback_dim=self.text_embed_dim, device=device)
        return self.pad_text_embeds(torch.from_numpy(emb).to(device))

    def _text_batch(self, texts, text_embeds, batch_size: int):
        """The text embeddings to condition on and the batch they set:
        `texts` (a string or a list) and `text_embeds` exclude each other."""
        if texts is not None and text_embeds is not None:
            raise ValueError("give texts or text_embeds, not both")
        if isinstance(texts, str):
            texts = [texts]
        if texts is not None:
            text_embeds = self.embed_texts(texts)
        if text_embeds is not None:
            batch_size = text_embeds.shape[0]
        return text_embeds, batch_size

    def tokenize_prime(self, prime_frames: torch.Tensor) -> torch.Tensor:
        """Prime frames (b, f, H, W, c), f - 1 a multiple of the temporal
        patch size -> their token ids (b, P), by the C-ViViT in eval mode."""
        device = self.maskgit.to_logits.weight.device
        ids = self.cvivit.tokenize(prime_frames.to(device))
        return ids.reshape(ids.shape[0], -1)

    @torch.inference_mode()
    def sample(self, *, num_frames: int, texts: Union[List[str], str, None] = None,
               text_embeds: Optional[torch.Tensor] = None,
               prime_frames: Optional[torch.Tensor] = None, batch_size: int = 1,
               cond_scale: float = 3.0, starting_temperature: float = 0.9, noise_K: float = 1.0,
               generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
        """Text-to-video sampling: (b, num_frames, H, W, c) in the C-ViViT pixel
        space. `texts` go through `embed_texts`; `text_embeds` are given
        embeddings (b, L, d) instead. `prime_frames` (b, f, H, W, c) are
        continued: the scene's `num_frames` (a multiple of the temporal patch
        size) follow them, and the MaskGit's `max_seq_len` must cover the
        prime's tokens and the scene's. `generator` (a CPU torch.Generator)
        seeds the sampling noise; `noise_K` scales the critic's score noise.
        `mesh` (every rank of it calls with the same arguments) shards the
        batch, which must divide by its data axes, and runs the trunks
        tensor-parallel over its tp axis (see the module docstring). A
        profiler sees the call as the span `phenaki.sample`."""
        with span("phenaki.sample"):
            text_embeds, batch_size = self._text_batch(texts, text_embeds, batch_size)
            if mesh is not None and mesh.size > 1:
                return self._sample_on_mesh(mesh, num_frames=num_frames, text_embeds=text_embeds,
                                            prime_frames=prime_frames, batch_size=batch_size,
                                            cond_scale=cond_scale, starting_temperature=starting_temperature,
                                            noise_K=noise_K, generator=generator)
            return self._sample(num_frames=num_frames, text_embeds=text_embeds, prime_frames=prime_frames,
                                batch_size=batch_size, cond_scale=cond_scale,
                                starting_temperature=starting_temperature, noise_K=noise_K, generator=generator)

    def _sample(self, *, num_frames: int, text_embeds: Optional[torch.Tensor],
                prime_frames: Optional[torch.Tensor], batch_size: int, generator: Optional[torch.Generator],
                **kwargs) -> torch.Tensor:
        """`sample` on this process's model and rows, inside its span."""
        prime_ids = None
        if prime_frames is not None:
            with span("phenaki.tokenize_prime"):
                prime_ids = self.tokenize_prime(prime_frames)
        ids = self.sample_ids(num_frames=num_frames, text_embeds=text_embeds, prime_ids=prime_ids,
                              batch_size=batch_size, generator=generator, **kwargs)
        with span("phenaki.cvivit_decode"):
            if prime_ids is None:
                return self.cvivit.decode_from_codebook_indices(ids)
            video = self.cvivit.decode_from_codebook_indices(torch.cat([prime_ids, ids], dim=-1))
        return video[:, prime_frames.shape[1]:]

    def _sample_on_mesh(self, mesh, *, text_embeds, prime_frames, batch_size: int,
                        generator: Optional[torch.Generator], **kwargs) -> torch.Tensor:
        n, shard = mesh.data_size, mesh.data_index
        if batch_size % n:
            raise ValueError(f"the sampling batch ({batch_size}) must divide by the mesh's data axes ({n})")
        if n > 1:
            generator = dp_generator(generator, shard, mesh.world_group)
        elif generator is None:
            generator = torch.Generator().manual_seed(collectives.shared_seed(None, mesh.world_group))
        rows = slice(shard * batch_size // n, (shard + 1) * batch_size // n)
        video = self._sampling_view(mesh)._sample(
            text_embeds=text_embeds[rows] if text_embeds is not None else None,
            prime_frames=prime_frames[rows] if prime_frames is not None else None,
            batch_size=batch_size // n, generator=generator, **kwargs)
        return collectives.all_gather(video, mesh.data_group, 0)

    @torch.inference_mode()
    def sample_images(self, *, texts: Union[List[str], str, None] = None, batch_size: int = 1,
                      cond_scale: float = 3.0, starting_temperature: float = 0.9,
                      noise_K: float = 1.0, num_frames: int = 1, **kwargs) -> torch.Tensor:
        """One-frame samples (b, H, W, c). `num_frames` is accepted, as the
        trainer passes it, and ignored: an image is one frame."""
        video = self.sample(texts=texts, num_frames=1, batch_size=batch_size, cond_scale=cond_scale,
                            starting_temperature=starting_temperature, noise_K=noise_K, **kwargs)
        return video[:, 0]

    @torch.inference_mode()
    def sample_ids(self, *, num_frames: int, text_embeds: Optional[torch.Tensor] = None,
                   prime_ids: Optional[torch.Tensor] = None, batch_size: int = 1,
                   cond_scale: float = 3.0, starting_temperature: float = 0.9,
                   noise_K: float = 1.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The decode loop of `sample`: the scene's token ids (b, n) int64.
        `prime_ids` (b, P) are the tokens of the prime frames
        (`tokenize_prime`), in front of the scene's."""
        self.maskgit.eval()
        dtype = self.maskgit.compute_dtype
        weight = self.maskgit.to_logits.weight
        device = weight.device
        with span("phenaki.prepare"):
            context = text_mask = None
            if text_embeds is not None:
                text_embeds = self.pad_text_embeds(text_embeds.to(device))
                batch_size = text_embeds.shape[0]
                text_mask = (text_embeds != 0).any(dim=-1)
                context = text_embeds.to(dtype)

            prime_num_frames = 0
            if prime_ids is not None:
                if prime_ids.shape[0] != batch_size:
                    raise ValueError(f"prime frames of batch {prime_ids.shape[0]} for a batch of {batch_size}")
                prime_num_frames = self.cvivit.frames_per_num_tokens(prime_ids.shape[1])
            num_tokens = self.cvivit.num_tokens_per_frames(num_frames, include_first_frame=not prime_num_frames)
            patch_shape = self.cvivit.get_video_patch_shape(num_frames + prime_num_frames)
            rel_pos_bias = self.maskgit.rel_pos_bias(patch_shape)
            vocab_proj = (weight.to(dtype), self.maskgit.to_logits.bias)

        def embeds_fn(ids):
            return self.maskgit.embeds_with_cond_scale(
                ids, video_patch_shape=patch_shape, context=context, text_mask=text_mask,
                cond_scale=cond_scale, attn_bias=rel_pos_bias,
            )

        critic_fn = None
        if self.critic is not None:
            self.critic.eval()
            # the critic sees the text only where it can attend to it; a
            # SelfCritic runs the MaskGit trunk and reuses its hoisted bias
            has_text = context is not None and (self.self_token_critic or self.critic.has_cross_attn)
            critic_kw = {"attn_bias": rel_pos_bias} if self.self_token_critic else {}

            def critic_fn(ids):
                return self.critic.forward_with_cond_scale(
                    ids, video_patch_shape=patch_shape, context=context if has_text else None,
                    text_mask=text_mask if has_text else None, cond_scale=cond_scale, **critic_kw)

        return maskgit_sample_loop(
            batch=batch_size,
            num_tokens_seq=num_tokens,
            mask_id=self.maskgit.mask_id,
            device=device,
            steps=self.steps,
            starting_temperature=starting_temperature,
            generator=generator,
            critic_fn=critic_fn,
            noise_K=noise_K,
            critic_noise_anneal_schedule=self.critic_noise_anneal_schedule,
            embeds_fn=embeds_fn,
            vocab_proj=vocab_proj,
            prime_ids=prime_ids,
        )

    def _loss_draws(self, b: int, n: int, generator: Optional[torch.Generator], device):
        """The loss's random draws: the step per sample (b,) int64 in
        [0, steps) and the uniforms (b, n) that choose the masked tokens."""
        gen_device = generator.device if generator is not None else device
        rand_step = torch.randint(0, self.steps, (b,), generator=generator, device=gen_device)
        return rand_step.to(device), uniform((b, n), generator, device)

    @staticmethod
    def _text_dropout(text_mask, drop_prob: float, generator, shard: int, shards: int):
        """Whole-sample conditioning dropout (the MaskGit's `_cond_dropout`),
        drawn for the global batch of `shards` ranks; this rank keeps its rows."""
        if text_mask is None or drop_prob <= 0:
            return text_mask
        keep = prob_mask_like((text_mask.shape[0] * shards,), 1.0 - drop_prob, generator,
                              device=text_mask.device)
        return text_mask & collectives.batch_rows(keep, shard, shards)[:, None]

    def _critic_sample_noise(self, b: int, n: int, v: int, generator: Optional[torch.Generator],
                             device) -> Optional[torch.Tensor]:
        """The uniforms (b, n, V) of the critic branch's generator sample, or
        None: the sampler then draws its own from `generator` (a seed on the
        card, the uniforms on the CPU)."""
        return None

    def loss(self, *, videos: Optional[torch.Tensor] = None,
             video_codebook_ids: Optional[torch.Tensor] = None,
             text_embeds: Optional[torch.Tensor] = None,
             video_frame_mask: Optional[torch.Tensor] = None,
             cond_drop_prob: Optional[float] = None, only_train_generator: bool = False,
             only_train_critic: bool = False, train: bool = True,
             generator: Optional[torch.Generator] = None, dp_group=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked-token cross-entropy of the generator, plus the critic's BCE
        when there is a critic: (loss, metrics) with metrics `maskgit_loss`,
        `critic_loss` (with a critic) and `loss`.

        videos (b, f, H, W, c) or images (b, H, W, c), pixels in [0, 1],
        which the C-ViViT tokenizes without a gradient, in its dtype and on
        the MaskGit's device; or video_codebook_ids (b, t, h, w) int, not
        both. text_embeds (b, L, d) with all-zero rows as padding;
        video_frame_mask (b, f) bool. Every random draw comes from
        `generator`, in this order: the step, the mask subset, the
        MaskGit's conditioning dropout, the generator's sample for the
        critic, the critic's conditioning dropout. `train` turns
        conditioning, attention and FF dropout on. `only_train_generator`
        leaves the critic out; `only_train_critic` detaches the generator's
        output and makes the loss the critic's alone. `dp_group` makes it a
        data-parallel rank's share of the global batch's loss (module
        docstring)."""
        if only_train_generator and only_train_critic:
            raise ValueError("only_train_generator and only_train_critic exclude each other")
        if (videos is None) == (video_codebook_ids is None):
            raise ValueError("give videos or video_codebook_ids, exactly one")
        if text_embeds is None and not self.maskgit.unconditional:
            raise ValueError("text embeds must be given unless unconditional")
        device = self.maskgit.to_logits.weight.device
        if videos is not None:
            video_codebook_ids = self.cvivit.tokenize(videos.to(device=device, dtype=self.cvivit.dtype))
        if video_codebook_ids.ndim != 4:
            raise ValueError("video_codebook_ids must be (b, t, h, w)")
        patch_shape = tuple(video_codebook_ids.shape[1:])
        ids = video_codebook_ids.reshape(video_codebook_ids.shape[0], -1).to(device).long()
        b, n = ids.shape

        text_mask, drop_prob = None, 0.0
        if not self.maskgit.unconditional:
            text_embeds = text_embeds.to(device)
            text_mask = (text_embeds != 0).any(dim=-1)
            drop_prob = cond_drop_prob if cond_drop_prob is not None else self.cond_drop_prob
        drop_prob = drop_prob if train else 0.0

        if video_frame_mask is not None:
            video_mask = self.cvivit.calculate_video_token_mask(video_frame_mask.to(device))
        else:
            video_mask = torch.ones((b, n), dtype=torch.bool, device=device)

        shard, shards = collectives.group_rank(dp_group), collectives.group_size(dp_group)

        def rows(t):
            return collectives.batch_rows(t, shard, shards)

        rand_step, noise = map(rows, self._loss_draws(b * shards, n, generator, device))
        mask_prob = torch.cos(rand_step.float() * math.pi * 0.5 / self.steps)
        mask_token_mask = get_mask_subset_with_prob(video_mask, mask_prob, noise=noise)
        masked_input = torch.where(mask_token_mask, self.maskgit.mask_id, ids)

        self.maskgit.train(train)
        proj = self.maskgit.to_logits
        fuse_ce = can_fuse_ce(proj.in_features, proj.out_features)
        out = self.maskgit(masked_input.reshape(b, *patch_shape), video_mask=video_mask,
                           text_mask=self._text_dropout(text_mask, drop_prob, generator, shard, shards),
                           context=text_embeds, return_embeds=fuse_ce,
                           **self._pipeline_kwargs(self.maskgit, generator))
        # read after the forward: under FSDP the head's whole weight is registered
        # from the MaskGit's forward on (its shard before)
        weight, bias = proj.weight, proj.bias
        # a tp rank's rows of the head: the whole one gathered once, in the compute dtype
        whole = None
        if fuse_ce and isinstance(proj, VocabShardedHead):
            whole = (*proj.gather(out.dtype), proj.row_offset)
        if only_train_critic:
            out = out.detach()
            weight, bias = weight.detach(), bias.detach() if bias is not None else None
        if fuse_ce:
            ce = fused_vocab_cross_entropy(out, weight, bias, ids, **({} if whole is None else {"whole": whole}))
            ce = ce.reshape(-1)
        else:
            out = out.float()
            ce = F.cross_entropy(out.reshape(b * n, -1), ids.reshape(-1), reduction="none")
        w = mask_token_mask.reshape(-1).float()
        # the global count over the ranks' mean: the ranks' losses average to the global one
        count = collectives.all_reduce(w.sum(), dp_group) / shards
        gen_loss = (ce * w).sum() / count.clamp_min(1.0 / shards)
        metrics = {"maskgit_loss": gen_loss}
        if self.critic is None or only_train_generator:
            metrics["loss"] = gen_loss
            return gen_loss, metrics

        # the critic: which tokens did the generator's sample change?
        temperature = self.critic_train_sample_temperature
        sample_noise = self._critic_sample_noise(b, n, proj.out_features, generator, device)
        if sample_noise is None and shards > 1 and device.type == "cpu":
            sample_noise = rows(uniform((b * shards, n, proj.out_features), generator, device))
        if fuse_ce:
            embeds = out.detach()
            if whole is not None:
                weight, bias = whole[0], whole[1]
            pred_ids, _ = project_sample(
                embeds, weight.detach().to(embeds.dtype), bias.detach() if bias is not None else None,
                temperature, generator=generator, noise=sample_noise)
        else:
            pred_ids = gumbel_sample(out.detach(), temperature, generator, noise=sample_noise)
        critic_input = torch.where(mask_token_mask, pred_ids, ids).reshape(b, *patch_shape)
        has_text = self.self_token_critic or self.critic.has_cross_attn
        self.critic.train(train)
        critic_text_mask = self._text_dropout(text_mask, drop_prob, generator, shard, shards) if has_text else None
        critic_trunk = self.maskgit if self.self_token_critic else self.critic
        critic_logits = self.critic(
            critic_input, video_mask=video_mask, text_mask=critic_text_mask,
            context=text_embeds if has_text else None,
            **self._pipeline_kwargs(critic_trunk, generator)).float()
        critic_loss = F.binary_cross_entropy_with_logits(critic_logits, (ids != pred_ids).float())
        metrics["critic_loss"] = critic_loss
        loss = critic_loss if only_train_critic else gen_loss + critic_loss * self.critic_loss_weight
        metrics["loss"] = loss
        return loss, metrics

    def __call__(self, videos: Optional[torch.Tensor] = None, *,
                 texts: Union[List[str], str, None] = None,
                 text_embeds: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        """The training loss alone: `texts` go through `embed_texts` (they
        and `text_embeds` exclude each other); the other keyword arguments
        are `loss`'s."""
        text_embeds, _ = self._text_batch(texts, text_embeds, 0)
        loss, _ = self.loss(videos=videos, text_embeds=text_embeds, generator=generator, **kwargs)
        return loss

    def save(self, path) -> None:
        """Write the MaskGit's, the critic's (a SelfCritic's head alone) and
        the C-ViViT's state dicts to one file."""
        save_pytree(path, {"maskgit": self.maskgit.state_dict(), "cvivit": self.cvivit.state_dict(),
                           "critic": self.critic.state_dict() if self.critic is not None else None})

    def load(self, path) -> None:
        """Restore what `save` wrote, into modules of the same shapes."""
        state = load_pytree(path)
        if (state["critic"] is None) != (self.critic is None):
            raise ValueError("the checkpoint and this Phenaki differ in having a critic")
        self.maskgit.load_state_dict(state["maskgit"])
        self.cvivit.load_state_dict(state["cvivit"])
        if self.critic is not None:
            self.critic.load_state_dict(state["critic"])


def make_video(phenaki: Phenaki, texts: Sequence[str], num_frames, prime_lengths, **sample_kwargs):
    """A long video as a chain of scenes, one a text: scene k + 1 is sampled
    with the last `prime_lengths[k]` frames of scene k as its prime frames
    (the last scene primes nothing). `num_frames` and `prime_lengths` are a
    number for every scene or a tuple; the keyword arguments go to every
    `Phenaki.sample`. Returns (the whole video (b, sum of frames, H, W, c),
    the list of scenes)."""
    num_scenes = len(texts)
    num_frames = num_frames if isinstance(num_frames, tuple) else (num_frames,) * num_scenes
    prime_lengths = prime_lengths if isinstance(prime_lengths, tuple) else (prime_lengths,) * (num_scenes - 1)
    prime_lengths = (*prime_lengths, 0)
    video_prime, scenes = None, []
    for text, scene_frames, next_prime_len in zip(texts, num_frames, prime_lengths):
        video = phenaki.sample(texts=text, prime_frames=video_prime, num_frames=scene_frames,
                               **sample_kwargs)
        scenes.append(video)
        video_prime = video[:, -next_prime_len:] if next_prime_len > 0 else None
    return torch.cat(scenes, dim=1), scenes
