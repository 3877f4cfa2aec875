"""Data parallelism, FSDP, consolidated checkpoints, the loader's shards
and serving on a mesh (phenaki_tpu_torch/parallel/, the trainers' `mesh=`
and `fsdp=`, `PhenakiServer(mesh=)`), fp32 on the CPU.

* `DataLoader(num_shards=, shard_id=)` gives each shard the indices of the
  JAX package's loader for the same seed; the shards cover the data with
  no overlap and drop the ragged tail (`tests/test_distributed.py:17-46`).
* Two gloo ranks, started once for the module (`spawn_ranks`):
  - dp = 2 sampling: the global batch on both ranks, the same for the same
    seed, and each rank's half bit-equal to that half sampled alone with
    its generator (`dp_generator`);
  - `PhenakiTrainer` at dp = 2 and with `fsdp=True` (a vocab of 2048, so
    that the embedding and the head shard; a TokenCritic, and a SelfCritic
    whose replicated head FSDP leaves alone) against one process on the
    global batch: losses at rtol 2e-4, atol 2e-5, parameters at rtol
    1e-3, atol 3e-4 (`tests/test_parallel.py:380-393, 639-650`), the ranks
    bit-identical;
  - `CViViTTrainer` at dp = 2 (the GAN suite, the R1 penalty on step 0),
    and with `fsdp=True` at dim 256 (its FF weights shard), against one
    process, likewise;
  - under FSDP the fused CE gets the head's whole weight, not its shard;
  - a consolidated checkpoint written at dp = 2 with FSDP and loaded at
    tp = 2 holds the same global tensors, and a resume on the same mesh
    is bit-equal to the trainer that went on;
  - `PhenakiServer(mesh=)` at tp = 2: its videos equal `sample(mesh=)`'s for
    the launches' seeds, and `close()` returns on both ranks.
* Four ranks at dp x tp = 2 x 2: the global batch on every rank, the same
  for the same seed, each shard within 2e-4 of the same shard sampled
  alone (greedy; the tp sum reassociates).

The rank functions import no JAX (a spawned rank imports this module by
name).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import phenaki_tpu_torch.training.phenaki_trainer as phenaki_trainer
from phenaki_tpu_torch.data.datasets import DataLoader
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki, dp_generator
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh, replicate, shard_batch
from phenaki_tpu_torch.serving import PhenakiServer
from phenaki_tpu_torch.text import t5
from phenaki_tpu_torch.training.cvivit_trainer import CViViTTrainer
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

TEXT_DIM = 16
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
GREEDY = dict(cond_scale=2.0, starting_temperature=0.0, noise_K=0.0)


def _phenaki(seed=0, num_tokens=64, critic="token"):
    gen = torch.Generator().manual_seed(seed)
    mg = dict(dim=32, num_tokens=num_tokens, max_seq_len=16, heads=2, dim_head=16, dim_context=TEXT_DIM)
    torch.manual_seed(seed)  # a SelfCritic's head takes torch's default init
    return Phenaki(maskgit=init_parameters(MaskGit(**mg, depth=2), gen),
                   cvivit=init_parameters(CViViT(**CVIVIT), gen),
                   critic=(init_parameters(TokenCritic(**mg, depth=1, has_cross_attn=True), gen)
                           if critic == "token" else None),
                   self_token_critic=critic == "self", text_embed_dim=TEXT_DIM, max_text_len=4, steps=3)


class _Ids(torch.utils.data.Dataset):
    def __init__(self, n=8, vocab=64, same=False):
        rng = np.random.RandomState(0)
        self.ids = rng.randint(0, vocab, size=(n, 2, 2, 2))
        self.emb = rng.randn(n, 3, TEXT_DIM).astype(np.float32)
        if same:
            self.ids[:], self.emb[:] = self.ids[0], self.emb[0]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def _quiet_setup():
    """No loader worker processes and the offline text encoder the
    milestone's caption falls back to, without the HF import."""
    phenaki_trainer.LOADER_WORKERS = 0
    t5._ENCODERS.setdefault((t5.DEFAULT_T5_NAME, TEXT_DIM, "cpu"), t5.HashTextEncoder(TEXT_DIM))


def _phenaki_trainer(results, mesh=None, fsdp=False, vocab=64, same=False, critic="token", **kw):
    _quiet_setup()
    return PhenakiTrainer(_phenaki(num_tokens=vocab, critic=critic), dataset=_Ids(vocab=vocab, same=same),
                          batch_size=4, seed=4, log_every=10**9, num_frames=3, num_samples=1,
                          sample_texts=["a cat"], results_folder=results, save_and_sample_every=10**9,
                          mesh=mesh, fsdp=fsdp, **kw)


def _train(trainer, steps=2):
    losses = [float(trainer.train_step()) for _ in range(steps)]
    tree = trainer._ckpt_tree(with_optimizer=False)["params"]
    return losses, {f"{part}.{k}": v.numpy() for part, sd in tree.items() for k, v in sd.items()}


def _videos(n=8):
    rng = np.random.RandomState(0)
    return [rng.rand(5, 16, 16, 3).astype(np.float32) for _ in range(n)]


def _cvivit_trainer(results, mesh=None, fsdp=False, dim=32):
    phenaki_trainer.LOADER_WORKERS = 0
    import phenaki_tpu_torch.training.cvivit_trainer as ct

    ct.LOADER_WORKERS = 0
    cv = init_parameters(CViViT(**dict(CVIVIT, dim=dim)), torch.Generator().manual_seed(0))
    return CViViTTrainer(cv, num_train_steps=3, batch_size=4, num_frames=5, discr_base_dim=4, valid_frac=0.0,
                         save_results_every=1000, save_model_every=1000, results_folder=results,
                         log_every=10**9, seed=3, dataset=_videos(), mesh=mesh, fsdp=fsdp, lr=1e-4)


def _cvivit_run(trainer):
    logs = [{k: float(v) for k, v in trainer.train_step().items()} for _ in range(2)]
    return logs, {k: v.float().numpy() for k, v in trainer._ckpt_tree()["vae"].items()}


def _text(b=2, seed=3):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, 3, TEXT_DIM).astype(np.float32))


def _fused_ce_weights_under_fsdp(dp):
    """One FSDP step with the fused CE's branch forced: whether the head's
    weight reached the fused CE as a DTensor (on the card its kernel would
    read a shard's pointer as the whole weight)."""
    import phenaki_tpu_torch.models.phenaki as phenaki_mod

    sharded = []
    fuse, ce = phenaki_mod.can_fuse_ce, phenaki_mod.fused_vocab_cross_entropy

    def recorded(h, weight, bias, labels):
        sharded.append(hasattr(weight, "placements"))
        return ce(h, weight, bias, labels)

    phenaki_mod.can_fuse_ce, phenaki_mod.fused_vocab_cross_entropy = (lambda d, v: True), recorded
    try:
        with tempfile.TemporaryDirectory() as results:
            _phenaki_trainer(results, dp, fsdp=True, vocab=2048).train_step()
    finally:
        phenaki_mod.can_fuse_ce, phenaki_mod.fused_vocab_cross_entropy = fuse, ce
    return sharded


def _two_rank_cases(rank, world, folder):
    dp = make_mesh(dp=2)
    out = {}
    multi = make_multislice_mesh()
    mine = torch.full((3,), float(rank))
    out["mesh"] = dict(multislice=dict(multi.shape), multislice_data=(multi.data_index, multi.data_size),
                       shard=shard_batch({"x": torch.arange(8), "texts": ["a", "b"]}, dp),
                       replicated=replicate(mine, dp).tolist())
    ph = _phenaki()
    text = _text()
    kw = dict(num_frames=3, text_embeds=text, cond_scale=2.0)
    out["dp_sample"] = [ph.sample(mesh=dp, generator=torch.Generator().manual_seed(7), **kw).numpy()
                        for _ in range(2)]
    out["dp_alone"] = ph.sample(num_frames=3, text_embeds=text[rank:rank + 1], cond_scale=2.0,
                                generator=dp_generator(torch.Generator().manual_seed(7), rank)).numpy()

    with tempfile.TemporaryDirectory() as results:
        out["dp_train"] = _train(_phenaki_trainer(results, dp))
    with tempfile.TemporaryDirectory() as results:
        trainer = _phenaki_trainer(results, dp, fsdp=True, vocab=2048)
        out["fsdp_sharded"] = sorted(n for n, p in trainer.model.maskgit.named_parameters()
                                     if hasattr(p, "placements"))
        out["fsdp_train"] = _train(trainer)
    with tempfile.TemporaryDirectory() as results:
        out["fsdp_self_train"] = _train(_phenaki_trainer(results, dp, fsdp=True, vocab=2048, critic="self"))
    with tempfile.TemporaryDirectory() as results:
        out["cvivit_dp"] = _cvivit_run(_cvivit_trainer(results, dp))
    with tempfile.TemporaryDirectory() as results:  # dim 256: the FF weights shard
        trainer = _cvivit_trainer(results, dp, fsdp=True, dim=256)
        out["cvivit_fsdp_sharded"] = sum(hasattr(p, "placements") for p in trainer.vae.parameters())
        out["cvivit_fsdp"] = _cvivit_run(trainer)
    out["fused_ce_weights"] = _fused_ce_weights_under_fsdp(dp)

    # consolidated checkpoints across meshes: written at dp = 2 with FSDP (step 1's milestone)
    tp = make_mesh(tp=2)
    a = _phenaki_trainer(os.path.join(folder, "a"), dp, fsdp=True, vocab=2048, same=True)
    a.train_step()
    written = a.checkpoints.restore(0)
    b = _phenaki_trainer(os.path.join(folder, "a"), tp, vocab=2048, same=True, fsdp=False)
    b.load(0)
    loaded = b._ckpt_tree()
    out["across_meshes"] = all(torch.equal(loaded["params"]["maskgit"][k], v)
                               for k, v in written["params"]["maskgit"].items())
    out["opt_across_meshes"] = all(torch.equal(loaded["opt_state"]["state"][i][k], v)
                                   for i, per in written["opt_state"]["state"].items()
                                   for k, v in per.items())
    a.train_step()
    c = _phenaki_trainer(os.path.join(folder, "c"), dp, fsdp=True, vocab=2048, same=True)
    c.checkpoints = a.checkpoints
    c.load(0)
    c.train_step()
    pa, pc = a._ckpt_tree(), c._ckpt_tree()
    out["resume_bit_equal"] = all(torch.equal(pa["params"]["maskgit"][k], v)
                                  for k, v in pc["params"]["maskgit"].items())

    # serving at tp = 2
    server = PhenakiServer(ph, mesh=tp, num_frames=3, cond_scale=2.0, batch_buckets=(1,), seed=5,
                           output_dtype="float32", max_delay_ms=1.0)
    served = None
    if rank == 0:
        served = [server.submit(text_embeds=text[i]).result(timeout=120) for i in range(2)]
    server.close(timeout=120)
    seeds = torch.Generator().manual_seed(5)
    expected = []
    for i in range(2):
        launch = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=seeds)))
        expected.append(ph.sample(num_frames=3, text_embeds=text[i:i + 1], cond_scale=2.0,
                                  starting_temperature=0.9, generator=launch, mesh=tp)[0].numpy())
    out["served"], out["serve_expected"] = served, expected
    return out


def _four_rank_cases(rank, world):
    mesh = make_mesh(dp=2, tp=2)
    ph = _phenaki()
    text = _text(4, seed=4)
    runs = [ph.sample(num_frames=3, text_embeds=text, mesh=mesh, generator=torch.Generator().manual_seed(11),
                      **GREEDY).numpy() for _ in range(2)]
    shard = mesh.dp_index
    alone = ph.sample(num_frames=3, text_embeds=text[2 * shard:2 * shard + 2], **GREEDY,
                      generator=dp_generator(torch.Generator().manual_seed(11), shard)).numpy()
    return dict(runs=runs, alone=alone, shard=shard)


@pytest.fixture(scope="module")
def two_ranks():
    with tempfile.TemporaryDirectory() as folder:
        yield spawn_ranks(_two_rank_cases, 2, folder, timeout=300)


@pytest.fixture(scope="module")
def one_process():
    out = {}
    with tempfile.TemporaryDirectory() as results:
        out["dp_train"] = _train(_phenaki_trainer(results))
    with tempfile.TemporaryDirectory() as results:
        out["fsdp_train"] = _train(_phenaki_trainer(results, vocab=2048))
    with tempfile.TemporaryDirectory() as results:
        out["fsdp_self_train"] = _train(_phenaki_trainer(results, vocab=2048, critic="self"))
    with tempfile.TemporaryDirectory() as results:
        out["cvivit_dp"] = _cvivit_run(_cvivit_trainer(results))
    with tempfile.TemporaryDirectory() as results:
        out["cvivit_fsdp"] = _cvivit_run(_cvivit_trainer(results, dim=256))
    return out


def _assert_train_matches(got, ref):
    (losses, params), (ref_losses, ref_params) = got, ref
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-5)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v, rtol=1e-3, atol=3e-4, err_msg=k)


def test_dataloader_shards_equal_jax_indices():
    from phenaki_tpu.data.datasets import DataLoader as JaxLoader

    for n, shards, batch, shuffle in ((10, 2, 1, True), (9, 2, 1, False), (23, 3, 2, True)):
        data = [np.full((1,), i, np.float32) for i in range(n)]
        seen = []
        for shard in range(shards):
            ours = [b[0][:, 0].astype(int).tolist() for b in DataLoader(
                data, batch_size=batch, seed=3, shuffle=shuffle, num_shards=shards, shard_id=shard)]
            theirs = [b[0][:, 0].astype(int).tolist() for b in JaxLoader(
                data, batch_size=batch, seed=3, shuffle=shuffle, num_shards=shards, shard_id=shard,
                num_workers=1)]
            assert ours == theirs and len(ours) == (n // shards) // batch
            seen += sum(ours, [])
        assert len(seen) == len(set(seen)) == (n // shards // batch) * batch * shards


def test_mesh_layouts_shard_batch_and_replicate(two_ranks):
    for rank, r in enumerate(two_ranks):
        m = r["mesh"]
        assert m["multislice"] == {"dcn": 1, "dp": 2, "tp": 1} and m["multislice_data"] == (rank, 2)
        assert m["shard"]["x"].tolist() == list(range(4 * rank, 4 * rank + 4))
        assert m["shard"]["texts"] == ["a", "b"]  # a list of strings is a leaf, as JAX keeps it whole
        assert m["replicated"] == [0.0, 0.0, 0.0]


def test_dp_sample_shards_the_batch(two_ranks):
    for r in two_ranks:
        assert r["dp_sample"][0].shape == (2, 3, 16, 16, 3)
        np.testing.assert_array_equal(r["dp_sample"][0], r["dp_sample"][1])  # the same seed
        np.testing.assert_array_equal(r["dp_sample"][0], two_ranks[0]["dp_sample"][0])
    for rank, r in enumerate(two_ranks):
        np.testing.assert_array_equal(r["dp_sample"][0][rank:rank + 1], r["dp_alone"])


def test_dp_trainer_matches_one_process(two_ranks, one_process):
    for r in two_ranks:
        _assert_train_matches(r["dp_train"], one_process["dp_train"])
    for k, v in two_ranks[0]["dp_train"][1].items():
        np.testing.assert_array_equal(two_ranks[1]["dp_train"][1][k], v)


@pytest.mark.parametrize("case", ["fsdp_train", "fsdp_self_train"])
def test_fsdp_trainer_matches_one_process(two_ranks, one_process, case):
    assert "token_emb.weight" in two_ranks[0]["fsdp_sharded"] and "to_logits.weight" in two_ranks[0]["fsdp_sharded"]
    for r in two_ranks:
        _assert_train_matches(r[case], one_process[case])
    for k, v in two_ranks[0][case][1].items():
        np.testing.assert_array_equal(two_ranks[1][case][1][k], v)


def test_fsdp_hands_the_fused_ce_the_whole_head_weight(two_ranks):
    for r in two_ranks:
        assert r["fused_ce_weights"] == [False]


@pytest.mark.parametrize("case", ["cvivit_dp", "cvivit_fsdp"])
def test_cvivit_trainer_matches_one_process(two_ranks, one_process, case):
    if case == "cvivit_fsdp":
        assert all(r["cvivit_fsdp_sharded"] > 0 for r in two_ranks)
    ref_logs, ref_params = one_process[case]
    for r in two_ranks:
        logs, params = r[case]
        for got, ref in zip(logs, ref_logs):
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5, err_msg=k)
        for k, v in ref_params.items():
            np.testing.assert_allclose(params[k], v, rtol=1e-3, atol=3e-4, err_msg=k)
    for k, v in two_ranks[0][case][1].items():
        np.testing.assert_array_equal(two_ranks[1][case][1][k], v)


def test_consolidated_checkpoint_across_meshes(two_ranks):
    for r in two_ranks:
        assert r["across_meshes"] and r["opt_across_meshes"]
        assert r["resume_bit_equal"]


def test_server_on_a_mesh_matches_mesh_sample(two_ranks):
    served, expected = two_ranks[0]["served"], two_ranks[0]["serve_expected"]
    assert len(served) == 2
    for got, want in zip(served, expected):
        np.testing.assert_array_equal(got, want)
    assert two_ranks[1]["served"] is None
    np.testing.assert_array_equal(two_ranks[1]["serve_expected"][0], expected[0])


def test_dp_tp_sample_on_four_ranks():
    ranks = spawn_ranks(_four_rank_cases, 4, timeout=300)
    for r in ranks:
        assert r["runs"][0].shape == (4, 3, 16, 16, 3)
        np.testing.assert_array_equal(r["runs"][0], r["runs"][1])
        np.testing.assert_array_equal(r["runs"][0], ranks[0]["runs"][0])
        s = r["shard"]
        np.testing.assert_allclose(r["runs"][0][2 * s:2 * s + 2], r["alone"], atol=2e-4)
    assert not np.allclose(ranks[0]["runs"][0][:2], ranks[0]["runs"][0][2:])
