"""Sequence-parallel models over a process group against the JAX package's
`seq_shard_mesh` models, fp32 on the CPU, on bridged weights.

Two gloo ranks, started once for the module (`spawn_ranks`), each run:

* a MaskGit built with `seq_group=` (its self-attention through the kernel
  ring, forced on the CPU, where the chunk is its plain version) against
  JAX `MaskGit(seq_shard_mesh=...)` on a 2-device mesh with the Pallas ring
  in interpret mode: logits at atol 5e-5;
* `Phenaki.loss` and every MaskGit gradient against `jax.value_and_grad` of
  the JAX loss on the sequence-sharded MaskGit, with the JAX draws fed to
  the port, at the tolerances of `test_torch_train.py` (loss rtol 1e-5,
  each gradient within 1e-3 * max|g|, max|g| floored at 1e-5);
* a 2-step `PhenakiTrainer` run (its step-1 milestone samples on the
  sequence-sharded model): the parameters after it are bit-identical
  across the ranks (every rank holds the full gradients, no all-reduce);
* C-ViViT `decode_from_codebook_indices` with 8 latent frames (its causal
  ALiBi temporal attention on the plain ring, 4 frames a rank) against
  JAX `CViViT(seq_shard_mesh=...)`: pixels at atol 5e-5;
* a sequence of 27 tokens, which does not divide by 2: the MaskGit takes
  dense attention (no ring call) and matches JAX at atol 5e-5.

The rank function imports no JAX: JAX is imported inside the fixtures and
tests only.
"""

import tempfile

import numpy as np
import pytest
import torch

import phenaki_tpu_torch.ops.attention as attention
import phenaki_tpu_torch.parallel.ring_attention as ra
from phenaki_tpu_torch.bridge import load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

TEXT_DIM, STEPS = 16, 4
CVIVIT = dict(dim=32, codebook_size=64, image_size=64, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=128, depth=2, heads=2, dim_head=16,
               dim_context=TEXT_DIM)
GRID = (2, 8, 8)  # 128 tokens: 64 a rank
DECODER = dict(dim=32, codebook_size=64, image_size=(16, 24), patch_size=8, temporal_patch_size=2,
               spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)


def _inputs():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, size=(2, *GRID)).astype(np.int32)
    emb = rng.randn(2, 6, TEXT_DIM).astype(np.float32)
    emb[0, 4:] = 0.0
    emb[1, 2:] = 0.0
    frame_mask = np.array([[1, 1, 1], [1, 0, 0]], bool)
    ids27 = rng.randint(0, 64, size=(2, 27)).astype(np.int32)
    dec_ids = rng.randint(0, 64, size=(1, 8 * 2 * 3))  # 8 latent frames of 2 x 3
    return dict(ids=ids, emb=emb, frame_mask=frame_mask, ids27=ids27, dec_ids=dec_ids)


class _Ids(torch.utils.data.Dataset):
    def __init__(self, n=8, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 64, size=(n, *GRID))
        self.emb = rng.randn(n, 5, TEXT_DIM).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def _rank_cases(rank, world, x, params, dec_params, draws):
    """Every case on this rank; results as numpy."""
    import torch.distributed as dist

    group = dist.group.WORLD
    ra._ring_use_flash = lambda *a: True  # the kernel ring's code, with the plain chunk
    ring_calls = []
    ring_fn = attention.sequence_sharded_attention

    def counted(*a, **kw):
        ring_calls.append(a[0].shape[2])
        return ring_fn(*a, **kw)

    attention.sequence_sharded_attention = counted
    out = {}
    mg = load_flax_params(MaskGit(**MASKGIT, seq_group=group), params)
    ids, emb = torch.from_numpy(x["ids"]).long(), torch.from_numpy(x["emb"])
    with torch.no_grad():
        out["logits"] = mg(ids, context=emb).numpy()
        out["logits27"] = mg(torch.from_numpy(x["ids27"]).long(), video_patch_shape=(3, 3, 3),
                             context=emb).numpy()
    out["ring_calls"] = list(ring_calls)

    ph = Phenaki(maskgit=mg, cvivit=CViViT(**CVIVIT), text_embed_dim=TEXT_DIM, steps=STEPS,
                 max_text_len=8)
    step, noise = draws
    ph._loss_draws = lambda b, n, gen, device: (torch.from_numpy(step).long(), torch.from_numpy(noise))
    loss, _ = ph.loss(video_codebook_ids=ids, text_embeds=emb,
                      video_frame_mask=torch.from_numpy(x["frame_mask"]), cond_drop_prob=0.0)
    loss.backward()
    out["loss"] = loss.item()
    out["grads"] = {n: p.grad.numpy() for n, p in mg.named_parameters()}

    gen = torch.Generator().manual_seed(3)
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    trained = init_parameters(MaskGit(**MASKGIT, seq_group=group), gen)
    with tempfile.TemporaryDirectory() as results:  # the step-1 milestone's sample and checkpoint
        trainer = PhenakiTrainer(Phenaki(maskgit=trained, cvivit=CViViT(**CVIVIT), text_embed_dim=TEXT_DIM,
                                         steps=STEPS), dataset=_Ids(), batch_size=2, train_lr=1e-3, seed=4,
                                 log_every=10**9, num_frames=3, num_samples=1, sample_texts=["a cat"],
                                 results_folder=results)
        out["train_losses"] = [trainer.train_step().item() for _ in range(2)]
    out["trained"] = {n: p.detach().numpy() for n, p in trained.named_parameters()}

    dec = load_flax_params(CViViT(**DECODER, seq_group=group), dec_params)
    with torch.no_grad():
        out["pixels"] = dec.decode_from_codebook_indices(torch.from_numpy(x["dec_ids"])).numpy()
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX models (sequence-sharded on a 2-device mesh), their weights
    and the loss's draws; Pallas in interpret mode for the module."""
    import jax
    import jax.numpy as jnp
    import phenaki_tpu.ops.pallas_attention as pa
    from phenaki_tpu.models.cvivit import CViViT as JCViViT
    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.models.phenaki import Phenaki as JPhenaki
    from phenaki_tpu.parallel.mesh import make_mesh
    from phenaki_tpu.utils.jit_init import jit_init

    saved, pa._INTERPRET = pa._INTERPRET, True
    mesh = make_mesh(jax.devices()[:2], tp=1)
    shard = dict(seq_shard_mesh=mesh, seq_shard_axis="dp")
    jcv = JCViViT(**CVIVIT)
    cv_vars = jit_init(jcv, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64, 3)))
    jmg = JMaskGit(**MASKGIT, **shard)
    jph = JPhenaki(maskgit=jmg, cvivit=jcv, cvivit_vars=cv_vars, steps=STEPS,
                   text_embed_dim=TEXT_DIM, max_text_len=8)
    jph.init(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jph.params["maskgit"]))
    jdec_dense, jdec = JCViViT(**DECODER), JCViViT(**DECODER, **shard)
    dec_vars = jit_init(jdec_dense, jax.random.PRNGKey(2), jnp.zeros((1, 3, 16, 24, 3)))
    dec_params = jax.tree_util.tree_map(np.asarray, jax.device_get(dec_vars["params"]))
    yield dict(jph=jph, jmg=jmg, params=params, jdec=jdec, dec_vars=dec_vars, dec_params=dec_params)
    pa._INTERPRET = saved


@pytest.fixture(scope="module")
def ranks(jax_side):
    import jax

    x = _inputs()
    rng_mask, rng_step = jax.random.split(jax.random.PRNGKey(7), 7)[:2]
    step = np.asarray(jax.random.randint(rng_step, (2,), 0, STEPS)).astype(np.int64)
    noise = np.asarray(jax.random.uniform(rng_mask, (2, x["ids"][0].size)))
    results = spawn_ranks(_rank_cases, 2, x, jax_side["params"], jax_side["dec_params"], (step, noise),
                          backend="gloo", timeout=600)
    return x, results


def test_maskgit_forward_matches_jax(jax_side, ranks):
    import jax.numpy as jnp

    x, results = ranks
    ref = jax_side["jmg"].apply({"params": jax_side["params"]}, jnp.asarray(x["ids"]),
                                video_patch_shape=GRID, context=jnp.asarray(x["emb"]))
    for r in results:
        np.testing.assert_allclose(r["logits"], np.asarray(ref), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(results[0]["logits"], results[1]["logits"])
    assert results[0]["ring_calls"] == [128, 128]  # one ring a layer; none at 27 tokens


def test_indivisible_sequence_takes_dense_attention(jax_side, ranks):
    import jax.numpy as jnp

    x, results = ranks
    ref = jax_side["jmg"].apply({"params": jax_side["params"]}, jnp.asarray(x["ids27"]),
                                video_patch_shape=(3, 3, 3), context=jnp.asarray(x["emb"]))
    for r in results:
        np.testing.assert_allclose(r["logits27"], np.asarray(ref), atol=5e-5, rtol=0)


def test_loss_and_grads_match_jax(jax_side, ranks):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu_torch.bridge import flax_to_state_dict

    x, results = ranks

    def j_loss(mg_params):
        loss, _ = jax_side["jph"].loss(
            {"maskgit": mg_params, "critic": None}, jax.random.PRNGKey(7),
            video_codebook_ids=jnp.asarray(x["ids"]), text_embeds=jnp.asarray(x["emb"]),
            video_frame_mask=jnp.asarray(x["frame_mask"]), cond_drop_prob=0.0)
        return loss

    ref_loss, ref_grads = jax.value_and_grad(j_loss)(
        jax.tree_util.tree_map(jnp.asarray, jax_side["params"]))
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(ref_grads)))
    for r in results:
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-5)
        assert sorted(ref) == sorted(r["grads"])
        for name, g in r["grads"].items():
            want = ref[name].numpy()
            np.testing.assert_allclose(g, want, atol=1e-3 * max(np.abs(want).max(), 1e-5), rtol=0,
                                       err_msg=name)


def test_trainer_ranks_stay_bit_identical(ranks):
    _, (a, b) = ranks
    assert a["train_losses"] == b["train_losses"] and all(np.isfinite(a["train_losses"]))
    assert sorted(a["trained"]) == sorted(b["trained"])
    for name in a["trained"]:
        np.testing.assert_array_equal(a["trained"][name], b["trained"][name], err_msg=name)


def test_cvivit_temporal_ring_matches_jax(jax_side, ranks):
    import jax.numpy as jnp
    from phenaki_tpu.models.cvivit import CViViT as JCViViT

    x, results = ranks
    ref = jax_side["jdec"].apply(jax_side["dec_vars"], jnp.asarray(x["dec_ids"]),
                                 method=JCViViT.decode_from_codebook_indices)
    for r in results:
        assert r["pixels"].shape == (1, 15, 16, 24, 3)
        np.testing.assert_allclose(r["pixels"], np.asarray(ref), atol=5e-5, rtol=0)
