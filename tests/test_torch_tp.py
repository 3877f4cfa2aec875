"""Tensor parallelism of the port (phenaki_tpu_torch/parallel/tp_inference.py,
mesh.py) against the JAX package, fp32 on the CPU.

* The placement rules as data: `param_partition_spec` on the port's names
  and shapes against JAX's on the flax paths of a MaskGit and a C-ViViT of
  the flagship's widths (shapes from `jax.eval_shape`, no weights), with and
  without `fsdp_size`, the JAX spec read in the port's layout.
* `pack_tp_params` on the bridged state_dict, bit-equal to the bridge
  applied to JAX's packed tree (the GEGLU's odd width 85 padded to 2 x 43),
  `unpack_tp_params` giving the state back, and both routes of
  `bridge.load_tp_flax_params`.
* Two gloo ranks, started once for the module (`spawn_ranks`), sample the
  bridged tiny Phenaki of `tests/test_parallel.py:_tiny_phenaki_for_sampling`
  at tp = 2, greedy (`starting_temperature=0`, `noise_K=0`), without a
  critic, with a TokenCritic and with a SelfCritic, and primed; each video
  against JAX's tp = 2 mesh sample within atol 2e-4, and the ranks' videos
  bit-identical. The same ranks train a tiny `PhenakiTrainer` at tp = 2 for
  two steps, against one process: losses at rtol 2e-4, atol 2e-5,
  parameters (consolidated) at rtol 1e-3, atol 3e-4
  (`tests/test_parallel.py:380-393`); the tp gradients, consolidated,
  against the dense model's. Each tp rank's trainer holds V / 2 rows of
  the MaskGit's vocab head and Adam's moments of them (JAX's vocab-parallel
  head), with and without a TokenCritic, on the materialised-logits path
  and on the fused CE's (d 128, V 512, where the loss gathers the head).

The rank function imports no JAX: JAX is imported inside the fixtures and
tests only.
"""

import tempfile

import numpy as np
import pytest
import torch

from phenaki_tpu_torch.bridge import (
    flax_to_state_dict,
    load_cvivit_variables,
    load_phenaki_params,
    load_tp_flax_params,
)
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.parallel.mesh import jax_dim_order, make_mesh, param_partition_spec
from phenaki_tpu_torch.text import t5
from phenaki_tpu_torch.parallel.tp_inference import (
    global_value,
    pack_tp_params,
    shard_packed,
    tp_local_module,
    unpack_tp_params,
)
import phenaki_tpu_torch.training.phenaki_trainer as phenaki_trainer
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

TEXT_DIM = 16
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=2, heads=2, dim_head=16, dim_context=TEXT_DIM)
CRITIC = dict(dim=32, num_tokens=64, max_seq_len=16, depth=1, heads=2, dim_head=16, has_cross_attn=True,
              dim_context=TEXT_DIM)
CRITICS = (None, "token", "self")
GREEDY = dict(cond_scale=2.0, starting_temperature=0.0, noise_K=0.0)


def _port_phenaki(critic_kind, params, cvivit_vars):
    cv = load_cvivit_variables(CViViT(**CVIVIT), cvivit_vars)
    ph = Phenaki(maskgit=MaskGit(**MASKGIT), cvivit=cv, text_embed_dim=TEXT_DIM, max_text_len=4, steps=2,
                 critic=TokenCritic(**CRITIC) if critic_kind == "token" else None,
                 self_token_critic=critic_kind == "self")
    return load_phenaki_params(ph, params)


def _inputs():
    return dict(text=np.random.RandomState(3).randn(2, 3, TEXT_DIM).astype(np.float32),
                text1=np.random.RandomState(5).randn(1, 3, TEXT_DIM).astype(np.float32),
                prime=np.random.RandomState(6).rand(1, 1, 16, 16, 3).astype(np.float32))


class _Ids(torch.utils.data.Dataset):
    def __init__(self, n=8):
        rng = np.random.RandomState(0)
        self.ids = rng.randint(0, 64, size=(n, 2, 2, 2))
        self.emb = rng.randn(n, 3, TEXT_DIM).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def _train_model():
    gen = torch.Generator().manual_seed(1)
    return Phenaki(maskgit=init_parameters(MaskGit(**MASKGIT), gen), cvivit=CViViT(**CVIVIT),
                   critic=init_parameters(TokenCritic(**CRITIC), gen), text_embed_dim=TEXT_DIM,
                   max_text_len=4, steps=3)


def _train(results, mesh=None):
    phenaki_trainer.LOADER_WORKERS = 0  # the batches in the calling process: no worker start-up
    # the offline encoder the milestone's caption falls back to, without the HF import
    t5._ENCODERS.setdefault((t5.DEFAULT_T5_NAME, TEXT_DIM, "cpu"), t5.HashTextEncoder(TEXT_DIM))
    trainer = PhenakiTrainer(_train_model(), dataset=_Ids(), batch_size=4, seed=4, log_every=10**9,
                             num_frames=3, num_samples=1, sample_texts=["a cat"], results_folder=results,
                             save_and_sample_every=10**9, mesh=mesh)
    losses = [float(trainer.train_step()) for _ in range(2)]
    params = {k: v.numpy() for k, v in trainer._ckpt_tree(with_optimizer=False)["params"]["maskgit"].items()}
    return losses, params


# the head-rows trainers: (critic, MaskGit width, vocab); a width of 128 and a
# vocab of 512 take the fused CE (`can_fuse_ce`), whose loss gathers the head
HEAD_CASES = {"token": ("token", 32, 64), "none": (None, 32, 64), "token_fused": ("token", 128, 512),
              "none_fused": (None, 128, 512)}


def _head_case_model(case):
    critic, dim, vocab = HEAD_CASES[case]
    gen = torch.Generator().manual_seed(1)
    cv = CViViT(**dict(CVIVIT, codebook_size=vocab))
    mg = init_parameters(MaskGit(**dict(MASKGIT, dim=dim, num_tokens=vocab)), gen)
    return Phenaki(maskgit=mg, cvivit=cv, text_embed_dim=TEXT_DIM, max_text_len=4, steps=3,
                   critic=init_parameters(TokenCritic(**dict(CRITIC, num_tokens=vocab)), gen) if critic else None)


def _head_case(results, case, mesh=None):
    """Two steps of a trainer on `case`'s model: the losses, the
    consolidated MaskGit and critic, and this rank's vocab-head rows and
    Adam moments' shapes."""
    phenaki_trainer.LOADER_WORKERS = 0
    t5._ENCODERS.setdefault((t5.DEFAULT_T5_NAME, TEXT_DIM, "cpu"), t5.HashTextEncoder(TEXT_DIM))
    trainer = PhenakiTrainer(_head_case_model(case), dataset=_Ids(), batch_size=4, seed=4, log_every=10**9,
                             num_frames=3, num_samples=1, sample_texts=["a cat"], results_folder=results,
                             save_and_sample_every=10**9, mesh=mesh, max_grad_norm=0.5)
    losses = [float(trainer.train_step()) for _ in range(2)]
    head = trainer.model.maskgit.to_logits
    moments = trainer.opt.state[head.weight]
    tree = trainer._ckpt_tree(with_optimizer=False)["params"]
    params = {f"{part}.{k}": v.numpy() for part, sub in tree.items() for k, v in sub.items()}
    return dict(losses=losses, params=params, head_rows=[tuple(head.weight.shape), tuple(head.bias.shape)],
                moment_rows=[tuple(moments["exp_avg"].shape), tuple(moments["exp_avg_sq"].shape)])


def _head_case_grads(case, mesh=None):
    """The loss (with the critic's) and the MaskGit's gradients on one batch,
    of `case`'s model or of its tp clone with the rank's head rows (global)."""
    ph = _head_case_model(case)
    shapes = {k: v.shape for k, v in ph.maskgit.state_dict().items()}
    model = ph.tp_shard(mesh, shard_head=True) if mesh is not None else ph
    ds = _Ids()
    ids = torch.from_numpy(np.stack([ds[i][0] for i in range(4)])).long()
    emb = torch.from_numpy(np.stack([ds[i][1] for i in range(4)]))
    loss, _ = model.loss(video_codebook_ids=ids, text_embeds=emb, generator=torch.Generator().manual_seed(0))
    loss.backward()
    grads = {n: (global_value(n, p.grad, mesh, shapes[n]) if mesh is not None else p.grad).numpy()
             for n, p in model.maskgit.named_parameters()}
    return dict(loss=loss.item(), grads=grads, head_rows=tuple(model.maskgit.to_logits.weight.shape))


def _dense_grads():
    """The loss and MaskGit gradients of the training model on one batch."""
    ph = _train_model()
    ds = _Ids()
    ids = torch.from_numpy(np.stack([ds[i][0] for i in range(4)])).long()
    emb = torch.from_numpy(np.stack([ds[i][1] for i in range(4)]))
    return ph, ids, emb


def _rank_cases(rank, world, trees, x):
    mesh = make_mesh(tp=2)
    out = {"samples": {}}
    text = torch.from_numpy(x["text"])
    for kind in CRITICS:
        ph = _port_phenaki(kind, *trees[kind])
        out["samples"][kind] = ph.sample(num_frames=3, text_embeds=text, mesh=mesh,
                                         generator=torch.Generator().manual_seed(9), **GREEDY).numpy()
    ph = _port_phenaki(None, *trees[None])
    out["primed"] = ph.sample(num_frames=2, text_embeds=torch.from_numpy(x["text1"]),
                              prime_frames=torch.from_numpy(x["prime"]), mesh=mesh,
                              generator=torch.Generator().manual_seed(13), **GREEDY).numpy()

    ph, ids, emb = _dense_grads()
    local = ph.tp_shard(mesh)
    loss, _ = local.loss(video_codebook_ids=ids, text_embeds=emb, generator=torch.Generator().manual_seed(0))
    loss.backward()
    shapes = {k: v.shape for k, v in ph.maskgit.state_dict().items()}
    out["loss"] = loss.item()
    out["grads"] = {n: global_value(n, p.grad, mesh, shapes[n]).numpy()
                    for n, p in local.maskgit.named_parameters()}
    out["head_grads"] = {case: _head_case_grads(case, mesh) for case in ("token", "token_fused")}
    with tempfile.TemporaryDirectory() as results:
        out["losses"], out["params"] = _train(results, mesh)
        out["head_cases"] = {case: _head_case(f"{results}/{case}", case, mesh) for case in HEAD_CASES}
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from phenaki_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from test_parallel import _tiny_phenaki_for_sampling

    x = _inputs()
    mesh = jax_make_mesh(jax.devices()[:2], dp=1, tp=2)
    trees, samples = {}, {}
    for kind in CRITICS:
        ph = _tiny_phenaki_for_sampling(kind)
        trees[kind] = jax.device_get((ph.params, ph.cvivit_vars))
        samples[kind] = np.asarray(ph.sample(num_frames=3, text_embeds=x["text"], mesh=mesh,
                                             rng=jax.random.PRNGKey(9), **GREEDY))
        if kind is None:
            primed = np.asarray(ph.sample(num_frames=2, text_embeds=x["text1"], prime_frames=x["prime"],
                                          mesh=mesh, rng=jax.random.PRNGKey(13), **GREEDY))
    return dict(x=x, trees=trees, samples=samples, primed=primed)


@pytest.fixture(scope="module")
def ranks(jax_side):
    return spawn_ranks(_rank_cases, 2, jax_side["trees"], jax_side["x"], timeout=300)


@pytest.mark.parametrize("critic", CRITICS)
def test_greedy_tp_sample_matches_jax_tp_mesh(jax_side, ranks, critic):
    for r in ranks:
        np.testing.assert_allclose(r["samples"][critic], jax_side["samples"][critic], atol=2e-4)
    np.testing.assert_array_equal(ranks[0]["samples"][critic], ranks[1]["samples"][critic])


def test_primed_tp_sample_matches_jax_tp_mesh(jax_side, ranks):
    for r in ranks:
        assert r["primed"].shape == (1, 2, 16, 16, 3)
        np.testing.assert_allclose(r["primed"], jax_side["primed"], atol=2e-4)


def test_tp_gradients_match_the_dense_model(ranks):
    ph, ids, emb = _dense_grads()
    loss, _ = ph.loss(video_codebook_ids=ids, text_embeds=emb, generator=torch.Generator().manual_seed(0))
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5)
        for n, p in ph.maskgit.named_parameters():
            g = p.grad.numpy()
            np.testing.assert_allclose(r["grads"][n], g, atol=1e-4 * max(np.abs(g).max(), 1e-3), err_msg=n)


def test_tp_trainer_matches_one_process(ranks):
    with tempfile.TemporaryDirectory() as results:
        losses, params = _train(results)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4, atol=2e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-3, atol=3e-4, err_msg=k)
    for k in params:
        np.testing.assert_array_equal(ranks[0]["params"][k], ranks[1]["params"][k])


@pytest.mark.parametrize("case", ["token", "token_fused"])
def test_tp_sharded_head_gradients_match_the_dense_model(ranks, case):
    """The loss and every MaskGit gradient of a tp clone that holds its rows
    of the vocab head (the materialised logits, or the fused CE on the
    gathered head with the critic's sampler on it) against the dense
    model's."""
    dense = _head_case_grads(case)
    for r in ranks:
        got = r["head_grads"][case]
        assert got["head_rows"][0] * 2 == dense["head_rows"][0]
        np.testing.assert_allclose(got["loss"], dense["loss"], rtol=1e-5)
        assert got["grads"].keys() == dense["grads"].keys()
        for n, g in dense["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g, atol=1e-4 * max(np.abs(g).max(), 1e-3), err_msg=n)


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_tp_trainer_holds_its_vocab_head_rows(ranks, case):
    """Each tp rank holds V / 2 rows of the head and of both Adam moments,
    and trains as one process does (consolidated MaskGit and critic)."""
    vocab = HEAD_CASES[case][2]
    with tempfile.TemporaryDirectory() as results:
        one = _head_case(results, case)
    assert one["head_rows"] == [(vocab, HEAD_CASES[case][1]), (vocab,)]
    for r in ranks:
        got = r["head_cases"][case]
        assert got["head_rows"] == [(vocab // 2, HEAD_CASES[case][1]), (vocab // 2,)]
        assert got["moment_rows"] == [got["head_rows"][0]] * 2
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-4, atol=2e-5)
        assert got["params"].keys() == one["params"].keys()
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-3, atol=3e-4, err_msg=f"{case} {k}")
    for k in one["params"]:
        np.testing.assert_array_equal(ranks[0]["head_cases"][case]["params"][k],
                                      ranks[1]["head_cases"][case]["params"][k])


def test_pack_tp_params_matches_the_bridged_jax_packing(jax_side):
    import jax

    from phenaki_tpu.parallel.tp_inference import pack_tp_params as jax_pack

    for kind in ("token", "self"):
        params, _ = jax_side["trees"][kind]
        for part in ("maskgit", "critic") if kind == "token" else ("maskgit",):
            tree = params[part]
            ours = pack_tp_params(flax_to_state_dict(tree), 2)
            theirs = flax_to_state_dict(jax.device_get(jax_pack(tree, 2)))
            assert ours.keys() == theirs.keys()
            for k in ours:
                assert torch.equal(ours[k], theirs[k]), k
            dense = flax_to_state_dict(tree)  # and the checkpoints' inverse gives it back
            back = unpack_tp_params(ours, 2, {k: v.shape for k, v in dense.items()})
            assert all(torch.equal(back[k], v) for k, v in dense.items())
    proj_in = ours["transformer.layers.0.ff.proj_in.weight"]
    assert proj_in.shape == (4 * 43, 32)  # [a_0 | g_0 | a_1 | g_1], 85 rows padded to 86 a half
    assert proj_in.reshape(2, 2, 43, 32)[1, :, 42].abs().sum() == 0  # rank 1's padding row


def test_both_bridge_routes_load_the_same_tp_shard(jax_side):
    import jax

    from phenaki_tpu.parallel.tp_inference import pack_tp_params as jax_pack

    params, _ = jax_side["trees"]["token"]
    tree = params["maskgit"]
    for rank in range(2):
        a = tp_local_module(MaskGit(**MASKGIT), 2, rank=rank)
        b = tp_local_module(MaskGit(**MASKGIT), 2, rank=rank)
        load_tp_flax_params(a, tree, 2, rank)
        load_tp_flax_params(b, jax.device_get(jax_pack(tree, 2)), 2, rank, packed=True)
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert sa["transformer.layers.0.self_attn.to_q.weight"].shape == (16, 32)  # 1 head of 2
        assert sa["transformer.layers.0.ff.proj_in.weight"].shape == (86, 32)
        full = shard_packed(pack_tp_params(flax_to_state_dict(tree), 2), 2, rank)
        assert all(torch.equal(sa[k], full[k]) for k in sa)


def _flagship_shapes():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.cvivit import CViViT as JCViViT
    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit

    mg = JMaskGit(dim=512, num_tokens=65536, max_seq_len=1152, depth=2, heads=8, dim_head=64,
                  dim_context=768)
    mg_shapes = jax.eval_shape(lambda: mg.init(jax.random.PRNGKey(0), jnp.zeros((1, 1152), jnp.int32),
                                               video_patch_shape=(9, 16, 8),
                                               context=jnp.zeros((1, 4, 768))))["params"]
    cv = JCViViT(dim=512, codebook_size=65536, image_size=(256, 128), patch_size=16, temporal_patch_size=2,
                 spatial_depth=1, temporal_depth=1, dim_head=64, heads=8)
    cv_shapes = jax.eval_shape(lambda: cv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 256, 128, 3))))["params"]
    return {"maskgit": mg_shapes, "cvivit": cv_shapes}


class _Leaf:
    """A shape as the JAX rules read a value: ndim, shape, size."""

    def __init__(self, shape):
        self.shape, self.ndim, self.size = tuple(shape), len(shape), int(np.prod(shape))


@pytest.mark.parametrize("fsdp_size", [1, 2])
def test_partition_rules_match_jax(fsdp_size):
    import jax

    from phenaki_tpu.parallel.mesh import param_partition_spec as jax_spec_of

    checked = 0
    for model, shapes in _flagship_shapes().items():
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        for path, leaf in flat:
            keys = [str(k.key) for k in path]
            name = next(iter(flax_to_state_dict(_nest(keys, np.zeros((1,) * len(leaf.shape), np.float32)))))
            spec = tuple(jax_spec_of(path, _Leaf(leaf.shape), True, fsdp_size))
            spec = spec + (None,) * (len(leaf.shape) - len(spec))
            order = jax_dim_order(name, len(leaf.shape))
            shape = [0] * len(order)
            ours_expected = [None] * len(order)
            for k, d in enumerate(order):
                shape[d] = leaf.shape[k]
                ours_expected[d] = spec[k]
            assert param_partition_spec(name, shape, True, fsdp_size) == tuple(ours_expected), (model, name)
            checked += 1
    assert checked > 100


def _nest(keys, value):
    tree = value
    for k in reversed(keys):
        tree = {k: tree}
    return tree

