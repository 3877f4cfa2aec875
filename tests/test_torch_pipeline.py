"""Pipeline parallelism of the port (phenaki_tpu_torch/parallel/pipeline.py,
the 'pp' axis of parallel/mesh.py, `Phenaki.pipeline_shard` and
`PhenakiTrainer(pp=)`) against the JAX package and the port's dense
model, fp32 on the CPU, on gloo ranks spawned once a module for each
world size (2 and 4, `spawn_ranks` with a timeout):

* the pipelined stack at pp = 2 with m = 2 and m = 4 and at pp = 4 with
  m = 4 against JAX's sequential `Transformer` and JAX's
  `pipeline_transformer_apply` on 2 or 4 of the 8 virtual devices, at
  `tests/test_pipeline.py`'s sizes (dim 32, depth 4, 2 heads, a CPB-like
  bias, key and context masks), the flax weights bridged (atol 1e-5); and
  with PEG on the per-microbatch grid;
* every gradient of a small MaskGit (the stage layers, `token_emb`,
  `pos_emb`, the CPB MLP, `norm_out`, `to_logits`) against the port's
  dense model at pp = 2, dp 2 x pp 2 and tp 2 x pp 2, the loss within
  rtol 1e-5 and each gradient within atol 1e-4 x max|g| (floored at
  1e-3, `tests/test_torch_tp.py`'s rule for tp gradients), so none is off
  by a factor of pp; each rank holds only its stage's trunk layers;
* dropout masks equal at pp = 1 and pp = 2;
* the placement rule (`pipeline_stage`) against JAX's
  `param_partition_spec(pp_size=)` on the flagship MaskGit's shapes, and
  the layers a stage is built from (`stage_layers`) against JAX's;
* a `PhenakiTrainer` at pp = 2 (its TokenCritic pipelined too, weight
  decay and a clipped global norm) against one process over 2 steps
  (losses rtol 2e-4, atol 2e-5; consolidated parameters rtol 1e-3, atol
  3e-4); its checkpoint loads at pp = 1, at tp = 2 and at pp = 2, the
  last resuming bit-identically; rank 1's trainer keeps no reference to the
  whole Phenaki it was given;
* FSDP composed with the pipeline: a dp 2 x pp 2 `fsdp=True` trainer on
  four ranks against one process over 2 steps (the same tolerances, the
  MaskGit and the critic), the consolidated parameters equal on every rank,
  each parameter's FSDP placement on each rank against JAX's
  `param_partition_spec(fsdp_size=2, pp_size=2)` of the same models with
  scanned layers (the size threshold lowered to 256 on both sides, as
  `tests/test_parallel.py` lowers JAX's for its tiny models), and on the
  flagship MaskGit's shapes at the real threshold; its checkpoint resumes
  bit-identically at dp 2 x pp 2 with FSDP and loads at dp 2 x tp 2, at
  dp 2 x pp 2 and in one process;
* a tp = 2 trainer's checkpoint (each rank holding its rows of the vocab
  head) loads at pp = 2, resumes bit-identically at tp = 2 and loads in
  one process.

The rank functions import no JAX: JAX is imported inside the fixtures and
tests only.
"""

import gc
import tempfile
import weakref

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.models.transformer import Transformer
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.parallel import mesh as mesh_rules
from phenaki_tpu_torch.parallel.fsdp import fsdp_shard_dim
from phenaki_tpu_torch.parallel.mesh import TRUNK_LAYER, jax_dim_order, make_mesh, pipeline_stage, stage_layers
from phenaki_tpu_torch.parallel.pipeline import pipeline_stage_module, pipeline_transformer_apply
from phenaki_tpu_torch.parallel.tp_inference import global_value
from phenaki_tpu_torch.text import t5
import phenaki_tpu_torch.training.phenaki_trainer as phenaki_trainer
from phenaki_tpu_torch.training.phenaki_trainer import PhenakiTrainer

torch.set_num_threads(1)

# tests/test_pipeline.py's sizes
DIM, DEPTH, HEADS, DH, CTX_DIM = 32, 4, 2, 16, 16
B, N, M_CTX = 4, 8, 5
JAX_CASES = ((2, 2), (2, 4), (4, 4))  # (pp, microbatches)

# a small MaskGit for the gradients (depth 4: two layers a stage at pp = 2)
GRAD_MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=4, heads=2, dim_head=16, dim_context=16)
GRAD_MESHES = {"pp2": dict(pp=2), "dp2_pp2": dict(dp=2, pp=2), "tp2_pp2": dict(tp=2, pp=2)}
GRAD_MICROBATCHES = 2

# the trainer's tiny models (tests/test_torch_tp.py's, the critic 2 layers deep)
TEXT_DIM = 16
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=2, heads=2, dim_head=16, dim_context=TEXT_DIM)
CRITIC = dict(dim=32, num_tokens=64, max_seq_len=16, depth=2, heads=2, dim_head=16, has_cross_attn=True,
              dim_context=TEXT_DIM)


def _port_transformer(peg=False):
    return Transformer(DIM, DEPTH, dim_context=None if peg else CTX_DIM, dim_head=DH, heads=HEADS, peg=peg,
                       has_cross_attn=not peg)


def _jax_inputs():
    rng = np.random.RandomState
    sam = np.ones((B, N), bool)
    sam[:, -2:] = False
    ccm = np.ones((B, M_CTX), bool)
    ccm[:, -1:] = False
    return dict(x=rng(0).randn(B, N, DIM).astype(np.float32),
                context=rng(1).randn(B, M_CTX, CTX_DIM).astype(np.float32),
                bias=(rng(2).randn(HEADS, N, N) * 0.1).astype(np.float32), sam=sam, ccm=ccm)


def _grad_batch():
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 64, (B, 2, 2, 2), generator=g)
    return ids, torch.randn(B, 3, 16, generator=g), torch.randint(0, 64, (B, 8), generator=g)


def _grad_model():
    return init_parameters(MaskGit(**GRAD_MASKGIT), torch.Generator().manual_seed(1))


def _ce(logits, targets, count):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="sum") / count


def _pipelined_grads(mesh):
    """This rank's rows through its stage-local MaskGit; the logits, the
    loss (its data shard's share), the global gradients (tp shards gathered,
    data shards summed) and the rank's parameter names."""
    mg = _grad_model()
    local = pipeline_stage_module(mg, mesh)
    ids, ctx, targets = _grad_batch()
    rows = B // mesh.data_size
    sl = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    logits = local(ids[sl], context=ctx[sl], pipeline_mesh=mesh, pipeline_microbatches=GRAD_MICROBATCHES)
    loss = _ce(logits, targets[sl], B * targets.shape[1])
    loss.backward()
    shapes = {k: v.shape for k, v in mg.state_dict().items()}
    grads = {n: collectives.all_reduce(global_value(n, p.grad, mesh, shapes[n]), mesh.data_group).numpy()
             for n, p in local.named_parameters()}
    return dict(logits=logits.detach().numpy(), rows=(sl.start, sl.stop),
                loss=collectives.all_reduce(loss.detach(), mesh.data_group).item(), grads=grads,
                names=[n for n, _ in local.named_parameters()])


def _jax_case_outputs(trees, mesh, cases):
    x = {k: torch.from_numpy(v) for k, v in trees["inputs"].items()}
    out = {}
    for pp, m in cases:
        tr = load_flax_params(_port_transformer(), trees["params"])
        local = pipeline_stage_module(tr, mesh)
        with torch.no_grad():
            out[(pp, m)] = pipeline_transformer_apply(
                local, x["x"], mesh, num_microbatches=m, attn_bias=x["bias"], context=x["context"],
                self_attn_mask=x["sam"], cross_attn_context_mask=x["ccm"]).numpy()
    return out


def _dropout_model():
    mg = MaskGit(**dict(GRAD_MASKGIT, depth=2), attn_dropout=0.3, ff_dropout=0.3)
    return init_parameters(mg, torch.Generator().manual_seed(2)).train()


def _dropout_logits(mesh, model):
    ids, ctx, _ = _grad_batch()
    with torch.no_grad():
        return model(ids, context=ctx, pipeline_mesh=mesh, pipeline_microbatches=2,
                     generator=torch.Generator().manual_seed(5)).numpy()


class _Ids(torch.utils.data.Dataset):
    def __init__(self, n=8):
        rng = np.random.RandomState(0)
        self.ids = rng.randint(0, 64, size=(n, 2, 2, 2))
        self.emb = rng.randn(n, 3, TEXT_DIM).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.emb[i]


def _phenaki():
    gen = torch.Generator().manual_seed(1)
    return Phenaki(maskgit=init_parameters(MaskGit(**MASKGIT), gen), cvivit=CViViT(**CVIVIT),
                   critic=init_parameters(TokenCritic(**CRITIC), gen), text_embed_dim=TEXT_DIM, max_text_len=4,
                   steps=3)


def _trainer(results, mesh=None, phenaki=None, **kw):
    phenaki_trainer.LOADER_WORKERS = 0  # the batches in the calling process: no worker start-up
    # the offline encoder the milestone's caption falls back to, without the HF import
    t5._ENCODERS.setdefault((t5.DEFAULT_T5_NAME, TEXT_DIM, "cpu"), t5.HashTextEncoder(TEXT_DIM))
    ph = phenaki if phenaki is not None else _phenaki()
    return PhenakiTrainer(ph, dataset=_Ids(), batch_size=4, seed=4, log_every=10**9, num_frames=3, num_samples=1,
                          sample_texts=["a cat"], results_folder=results, save_and_sample_every=10**9, mesh=mesh,
                          wd=0.01, max_grad_norm=0.5, **kw)


def _maskgit_params(trainer, with_optimizer=False):
    tree = trainer._ckpt_tree(with_optimizer=with_optimizer)
    params = {k: v.numpy() for k, v in tree["params"]["maskgit"].items()}
    return (params, tree) if with_optimizer else params


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _train_cases(folder):
    """A: pp = 2 with the TokenCritic pipelined, step 1 (the milestone writes
    checkpoint 0) and step 2; B: pp = 2 loads checkpoint 0 and takes step 2
    on A's second batch; C: tp = 2 loads checkpoint 0. Whether the whole
    MaskGit given to A outlives the caller's reference to it (rank 0 keeps
    it for the milestones' samples)."""
    ph = _phenaki()
    whole = weakref.ref(ph.maskgit)
    a = _trainer(f"{folder}/a", phenaki=ph, pp=2, pipeline_microbatches=2)
    del ph
    gc.collect()
    out = {"stage_names": {"maskgit": [n for n, _ in a.model.maskgit.named_parameters()],
                           "critic": [n for n, _ in a.model.critic.named_parameters()]},
           "keeps_whole_maskgit": whole() is not None}
    out["losses"] = [float(a.train_step()) for _ in range(2)]
    out["params"] = _maskgit_params(a)
    b = _trainer(f"{folder}/b", pp=2, pipeline_microbatches=2)
    b.checkpoints = a.checkpoints
    next(b.dl)  # the batch A's first step took (a checkpoint holds no data order)
    b.load(0)
    b.train_step()
    out["resume_bit_equal"] = all(np.array_equal(v, out["params"][k]) for k, v in _maskgit_params(b).items())
    c = _trainer(f"{folder}/c", mesh=make_mesh(tp=2))
    c.checkpoints = a.checkpoints
    c.load(0)
    _, tree = _maskgit_params(c, with_optimizer=True)
    written = a.checkpoints.restore(0)
    out["tp_load_equal"] = _trees_equal(tree["params"], written["params"]) and _trees_equal(
        tree["opt_state"], written["opt_state"])
    torch.distributed.barrier()
    return out


def _loads_equal(trainer, checkpoints, milestone=0):
    """Whether `trainer`, loading checkpoint `milestone`, consolidates to the
    file's parameters and Adam state exactly."""
    trainer.checkpoints = checkpoints
    trainer.load(milestone)
    tree = trainer._ckpt_tree()
    written = checkpoints.restore(milestone)
    return _trees_equal(tree["params"], written["params"]) and _trees_equal(tree["opt_state"], written["opt_state"])


def _all_params(trainer):
    tree = trainer._ckpt_tree(with_optimizer=False)["params"]
    return {f"{part}.{k}": v.numpy() for part, sub in tree.items() for k, v in sub.items()}


def _sharded_head_cases(folder):
    """E: tp = 2 (each rank its rows of the vocab head), step 1 writes
    checkpoint 0, then step 2; F: pp = 2 loads it; G: tp = 2 loads it and
    takes E's step 2."""
    e = _trainer(f"{folder}/e", mesh=make_mesh(tp=2))
    head_rows = tuple(e.model.maskgit.to_logits.weight.shape)
    e.train_step()
    e.train_step()
    params = _all_params(e)
    out = {"head_rows": head_rows,
           "pp_load_equal": _loads_equal(_trainer(f"{folder}/f", pp=2, pipeline_microbatches=2), e.checkpoints)}
    g = _trainer(f"{folder}/g", mesh=make_mesh(tp=2))
    next(g.dl)  # the batch E's first step took
    g.checkpoints = e.checkpoints
    g.load(0)
    g.train_step()
    out["resume_bit_equal"] = all(np.array_equal(v, params[k]) for k, v in _all_params(g).items())
    torch.distributed.barrier()
    return out


def _rank2(rank, world, trees, folder):
    torch.set_num_threads(1)
    mesh = make_mesh(pp=2)
    return dict(jax_cases=_jax_case_outputs(trees, mesh, [c for c in JAX_CASES if c[0] == 2]),
                peg=_peg_output(trees, mesh), grads=_pipelined_grads(mesh),
                dropout=_dropout_logits(mesh, pipeline_stage_module(_dropout_model(), mesh)),
                train=_train_cases(folder), sharded_head=_sharded_head_cases(folder))


# the FSDP x pp trainer's size threshold: JAX's tests lower `_FSDP_MIN_SIZE`
# to 256 for their tiny models (tests/test_parallel.py), so that layers shard
FSDP_TEST_MIN_SIZE = 256


def _fsdp_dim(p):
    placements = getattr(p, "placements", None)
    return next((q.dim for q in placements if hasattr(q, "dim")), None) if placements else None


def _record_grads(trainer, mesh=None):
    """A list that gains each step's gradients (the clipped ones Adam reads),
    consolidated over the data and tp groups, by name."""
    steps = []

    def hook(*_):
        steps.append({n: (global_value(n, p.grad, mesh, trainer.global_shapes[n]) if mesh is not None
                          else p.grad.detach().clone()).numpy() for n, p in trainer._named_params()})

    trainer.opt.register_step_pre_hook(hook)
    return steps


def _fsdp_pipeline_cases(folder):
    """A: dp 2 x pp 2 with FSDP, 4 microbatches, step 1 (checkpoint 0) and
    step 2; B: the same loads checkpoint 0 and takes A's step 2; C: dp 2 x
    tp 2 and D: dp 2 x pp 2 without FSDP load it."""
    mesh_rules.FSDP_MIN_SIZE = FSDP_TEST_MIN_SIZE
    mesh = make_mesh(dp=2, pp=2)
    a = _trainer(f"{folder}/fa", mesh=mesh, fsdp=True, pipeline_microbatches=4)
    out = {"placement": {f"{part}.{n}": _fsdp_dim(p) for part in ("maskgit", "critic")
                         for n, p in getattr(a.model, part).named_parameters()},
           "stage": mesh.pp_index}
    grads = _record_grads(a, mesh)
    out["losses"] = [float(a.train_step()) for _ in range(2)]
    out["grads"] = grads[0]
    out["params"] = _all_params(a)
    b = _trainer(f"{folder}/fb", mesh=mesh, fsdp=True, pipeline_microbatches=4)
    next(b.dl)  # the batch A's first step took
    b.checkpoints = a.checkpoints
    b.load(0)
    b.train_step()
    out["resume_bit_equal"] = all(np.array_equal(v, out["params"][k]) for k, v in _all_params(b).items())
    out["tp_load_equal"] = _loads_equal(_trainer(f"{folder}/fc", mesh=make_mesh(tp=2)), a.checkpoints)
    out["pp_load_equal"] = _loads_equal(_trainer(f"{folder}/fd", mesh=mesh, pipeline_microbatches=4),
                                        a.checkpoints)
    torch.distributed.barrier()
    return out


def _peg_output(trees, mesh):
    tr = load_flax_params(_port_transformer(peg=True), trees["peg_params"])
    with torch.no_grad():
        return pipeline_transformer_apply(pipeline_stage_module(tr, mesh), torch.from_numpy(trees["inputs"]["x"]),
                                          mesh, num_microbatches=2, video_shape=(B, 2, 2, 2)).numpy()


def _rank4(rank, world, trees, folder):
    torch.set_num_threads(1)
    out = {"jax_cases": _jax_case_outputs(trees, make_mesh(pp=4), [c for c in JAX_CASES if c[0] == 4])}
    for label, axes in GRAD_MESHES.items():
        if label != "pp2":
            out[label] = _pipelined_grads(make_mesh(**axes))
    out["fsdp_pp"] = _fsdp_pipeline_cases(folder)
    out["fsdp_tp"] = _fsdp_tp_case(folder)
    return out


def _fsdp_tp_case(folder):
    """dp 2 x tp 2 with FSDP (the threshold lowered as above): two steps, and
    where the vocab head's weight and bias lie (tp rows, FSDP dim)."""
    mesh_rules.FSDP_MIN_SIZE = FSDP_TEST_MIN_SIZE
    trainer = _trainer(f"{folder}/tp", mesh=make_mesh(tp=2), fsdp=True)
    head = trainer.model.maskgit.to_logits
    out = {"head": [(tuple(p.shape), _fsdp_dim(p)) for p in (head.weight, head.bias)]}
    out["losses"] = [float(trainer.train_step()) for _ in range(2)]
    out["params"] = _all_params(trainer)
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.transformer import Transformer as JTransformer
    from phenaki_tpu.parallel.pipeline import make_pipeline_mesh as jax_pipeline_mesh
    from phenaki_tpu.parallel.pipeline import pipeline_transformer_apply as jax_pipeline

    x = _jax_inputs()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    tr = JTransformer(dim=DIM, depth=DEPTH, dim_context=CTX_DIM, dim_head=DH, heads=HEADS, peg=False,
                      has_cross_attn=True, scan_layers=True)
    variables = tr.init(jax.random.PRNGKey(0), j["x"], context=j["context"])
    sequential = np.asarray(tr.apply(variables, j["x"], attn_bias=j["bias"], context=j["context"],
                                     self_attn_mask=j["sam"], cross_attn_context_mask=j["ccm"]))
    pipelined = {}
    for pp, m in JAX_CASES:
        pipelined[(pp, m)] = np.asarray(jax_pipeline(
            tr, variables["params"], j["x"], jax_pipeline_mesh(pp, jax.devices()[:pp]), num_microbatches=m,
            attn_bias=j["bias"], context=j["context"], self_attn_mask=j["sam"], cross_attn_context_mask=j["ccm"]))
    peg = JTransformer(dim=DIM, depth=DEPTH, dim_head=DH, heads=HEADS, peg=True, peg_layout="thw",
                       has_cross_attn=False, scan_layers=True)
    peg_vars = peg.init(jax.random.PRNGKey(1), j["x"], video_shape=(B, 2, 2, 2))
    peg_out = np.asarray(peg.apply(peg_vars, j["x"], video_shape=(B, 2, 2, 2)))
    trees = dict(inputs=x, params=jax.device_get(variables["params"]), peg_params=jax.device_get(peg_vars["params"]))
    return dict(trees=trees, sequential=sequential, pipelined=pipelined, peg=peg_out)


@pytest.fixture(scope="module")
def shared_folder():
    with tempfile.TemporaryDirectory() as folder:
        yield folder


@pytest.fixture(scope="module")
def shared_folder4():
    with tempfile.TemporaryDirectory() as folder:
        yield folder


@pytest.fixture(scope="module")
def ranks2(jax_side, shared_folder):
    return spawn_ranks(_rank2, 2, jax_side["trees"], shared_folder, timeout=300)


@pytest.fixture(scope="module")
def ranks4(jax_side, shared_folder4):
    return spawn_ranks(_rank4, 4, jax_side["trees"], shared_folder4, timeout=300)


@pytest.mark.parametrize("pp,microbatches", JAX_CASES)
def test_pipeline_matches_jax_sequential_and_pipelined(jax_side, ranks2, ranks4, pp, microbatches):
    results = ranks2 if pp == 2 else ranks4
    for r in results:
        got = r["jax_cases"][(pp, microbatches)]
        np.testing.assert_allclose(got, jax_side["sequential"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, jax_side["pipelined"][(pp, microbatches)], atol=1e-5, rtol=0)


def test_pipeline_with_peg_grid(jax_side, ranks2):
    for r in ranks2:
        np.testing.assert_allclose(r["peg"], jax_side["peg"], atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def dense_grads():
    mg = _grad_model()
    ids, ctx, targets = _grad_batch()
    logits = mg(ids, context=ctx)
    loss = _ce(logits, targets, targets.numel())
    loss.backward()
    return dict(logits=logits.detach().numpy(), loss=loss.item(),
                grads={n: p.grad.numpy() for n, p in mg.named_parameters()})


@pytest.mark.parametrize("mesh", list(GRAD_MESHES))
def test_every_gradient_matches_the_dense_model(dense_grads, ranks2, ranks4, mesh):
    results = [r["grads"] for r in ranks2] if mesh == "pp2" else [r[mesh] for r in ranks4]
    depth, pp = GRAD_MASKGIT["depth"], GRAD_MESHES[mesh]["pp"]
    checked = set()
    for r in results:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["logits"], dense_grads["logits"][lo:hi], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["loss"], dense_grads["loss"], rtol=1e-5)
        # the rank holds its stage's trunk layers and nothing of the others'
        stages = {pipeline_stage(n, depth, pp) for n in r["names"]} - {None}
        assert len(stages) == 1, (mesh, stages)
        for n, g in r["grads"].items():
            want = dense_grads["grads"][n]
            np.testing.assert_allclose(g, want, atol=1e-4 * max(np.abs(want).max(), 1e-3), err_msg=f"{mesh} {n}")
            checked.add(n)
    assert checked == set(dense_grads["grads"])  # every parameter, on some stage
    for name in ("token_emb.weight", "pos_emb.weight", "continuous_pos_bias.net_out.weight",
                 "transformer.norm_out.gamma", "to_logits.weight"):
        assert all(name in r["grads"] for r in results), name  # replicated on every stage


def test_dropout_masks_equal_at_pp1_and_pp2(ranks2):
    one = _dropout_logits(make_mesh(), _dropout_model())
    for r in ranks2:
        np.testing.assert_allclose(r["dropout"], one, atol=1e-6, rtol=0)
    ids, ctx, _ = _grad_batch()
    with torch.no_grad():
        plain = _dropout_model().eval()(ids, context=ctx).numpy()
    assert np.abs(one - plain).max() > 1e-2  # the masks did act


@pytest.mark.parametrize("pp", [2, 3, 4])
def test_pipeline_placement_rule_matches_jax(pp):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.parallel.mesh import param_partition_spec as jax_spec_of

    depth = 6
    mg = JMaskGit(dim=512, num_tokens=65536, max_seq_len=1152, depth=depth, heads=8, dim_head=64,
                  dim_context=768, scan_layers=True)
    shapes = jax.eval_shape(lambda: mg.init(jax.random.PRNGKey(0), jnp.zeros((1, 1152), jnp.int32),
                                            video_patch_shape=(9, 16, 8), context=jnp.zeros((1, 4, 768))))["params"]

    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim, self.size = tuple(shape), len(shape), int(np.prod(shape))

    checked, jax_stage = 0, {}  # JAX's stage of each trunk layer
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(k.key) for k in path]
        spec = tuple(jax_spec_of(path, Leaf(leaf.shape), True, 1, pp))
        stacked = "layers_scan" in keys
        tree = np.zeros((leaf.shape[0],) + (1,) * (len(leaf.shape) - 1) if stacked else (1,) * len(leaf.shape),
                        np.float32)
        for k in reversed(keys):
            tree = {k: tree}
        names = list(flax_to_state_dict(tree))  # one a layer for the stacked leaves
        assert len(names) == (depth if stacked else 1)
        for i, name in enumerate(names):
            want = i // (depth // pp) if spec and spec[0] == "pp" else None
            assert pipeline_stage(name, depth, pp) == want, (pp, name, spec)
            if stacked:
                assert jax_stage.setdefault(i, want) == want
            checked += 1
    assert checked > 100
    # the layers a rank's stage is built from (`pipeline_stage_module`) are
    # JAX's; where pp does not divide the depth JAX replicates them and the
    # port's pipeline refuses the trunk
    if depth % pp:
        assert set(jax_stage.values()) == {None}
        with pytest.raises(ValueError):
            stage_layers(depth, pp, 0)
    for stage in range(pp if depth % pp == 0 else 0):
        assert list(stage_layers(depth, pp, stage)) == [i for i in range(depth) if jax_stage[i] == stage]


def test_pipeline_trainer_matches_one_process(ranks2):
    with tempfile.TemporaryDirectory() as results:
        one = _trainer(results)
        losses = [float(one.train_step()) for _ in range(2)]
        params = _maskgit_params(one)
    for r in ranks2:
        t = r["train"]
        np.testing.assert_allclose(t["losses"], losses, rtol=2e-4, atol=2e-5)
        assert t["params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(t["params"][k], v, rtol=1e-3, atol=3e-4, err_msg=k)
    for k in params:
        np.testing.assert_array_equal(ranks2[0]["train"]["params"][k], ranks2[1]["train"]["params"][k])
    # rank 0 keeps the whole Phenaki for the milestones' samples; rank 1 none of it
    assert [r["train"]["keeps_whole_maskgit"] for r in ranks2] == [True, False]
    for rank, r in enumerate(ranks2):  # each rank trains its stage's layers alone
        for part in ("maskgit", "critic"):
            layers = {n.split(".")[2] for n in r["train"]["stage_names"][part] if n.startswith("transformer.layers.")}
            assert layers == {str(rank)}, (part, layers)


def test_pipeline_checkpoint_loads_at_pp1_tp2_and_pp2(ranks2, ranks4, shared_folder, shared_folder4):
    for r in ranks2:
        assert r["train"]["resume_bit_equal"]
        assert r["train"]["tp_load_equal"]
    with tempfile.TemporaryDirectory() as results:
        one = _trainer(results)
        one.checkpoints.directory = phenaki_trainer.Path(shared_folder) / "a" / "checkpoints"
        next(one.dl)  # the batch the pipeline's first step took
        one.load(0)
        written = one.checkpoints.restore(0)
        assert _trees_equal(one._ckpt_tree()["params"], written["params"])
        assert _trees_equal(one.opt.state_dict(), written["opt_state"])
        one.train_step()
        for k, v in _maskgit_params(one).items():  # its step 2 is the pipeline's, within the trainer tolerance
            np.testing.assert_allclose(v, ranks2[0]["train"]["params"][k], rtol=1e-3, atol=3e-4, err_msg=k)
    # the FSDP x pp checkpoint (four ranks) and the sharded-head one (tp = 2)
    for r in ranks4:
        f = r["fsdp_pp"]
        assert f["resume_bit_equal"] and f["tp_load_equal"] and f["pp_load_equal"]
    for r in ranks2:
        h = r["sharded_head"]
        assert h["head_rows"] == (MASKGIT["num_tokens"] // 2, MASKGIT["dim"])
        assert h["pp_load_equal"] and h["resume_bit_equal"]
    for folder in (f"{shared_folder4}/fa", f"{shared_folder}/e"):
        with tempfile.TemporaryDirectory() as results:
            one = _trainer(results)
            one.checkpoints.directory = phenaki_trainer.Path(folder) / "checkpoints"
            one.load(0)
            written = one.checkpoints.restore(0)
            assert _trees_equal(one._ckpt_tree()["params"], written["params"]), folder
            assert _trees_equal(one.opt.state_dict(), written["opt_state"]), folder


def test_fsdp_pipeline_trainer_matches_one_process(ranks4):
    """dp 2 x pp 2 with FSDP against one process: the losses and every
    parameter of the MaskGit and the critic after 2 steps, equal on all four
    ranks, and step 1's gradient of every parameter a rank holds (so that
    none is lost or averaged twice: Adam's first steps barely see a scale)."""
    with tempfile.TemporaryDirectory() as results:
        one = _trainer(results)
        grads = _record_grads(one)
        losses = [float(one.train_step()) for _ in range(2)]
        params = _all_params(one)
    for r in ranks4:
        f = r["fsdp_pp"]
        for n, g in f["grads"].items():
            want = grads[0][n]
            np.testing.assert_allclose(g, want, atol=1e-4 * max(np.abs(want).max(), 1e-3), err_msg=n)
        np.testing.assert_allclose(f["losses"], losses, rtol=2e-4, atol=2e-5)
        assert f["params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(f["params"][k], v, rtol=1e-3, atol=3e-4, err_msg=k)
    for r in ranks4[1:]:
        for k in params:
            np.testing.assert_array_equal(r["fsdp_pp"]["params"][k], ranks4[0]["fsdp_pp"]["params"][k])


def _jax_fsdp_pp_specs(models, depth_of):
    """JAX's `param_partition_spec(..., fsdp_size=2, pp_size=2)` of each
    model's scanned parameter tree, read as the port's per-layer names:
    {name: (stage or None, the port's dim on 'dp' or None)}."""
    import jax

    from phenaki_tpu.parallel.mesh import param_partition_spec as jax_spec_of

    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim, self.size = tuple(shape), len(shape), int(np.prod(shape))

    out = {}
    for part, shapes in models.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            keys = [str(k.key) for k in path]
            spec = tuple(jax_spec_of(path, Leaf(leaf.shape), False, 2, 2))  # tp = 1: JAX's trainer passes False
            spec = spec + (None,) * (len(leaf.shape) - len(spec))
            stacked = "layers_scan" in keys
            tree = np.zeros((leaf.shape[0],) + (1,) * (len(leaf.shape) - 1) if stacked else (1,) * len(leaf.shape),
                            np.float32)
            for k in reversed(keys):
                tree = {k: tree}
            per_layer = spec[1:] if stacked else spec
            for i, name in enumerate(flax_to_state_dict(tree)):
                order = jax_dim_order(name, len(per_layer))
                dp_dim = next((d for k, d in enumerate(order) if per_layer[k] == "dp"), None)
                stage = i // (depth_of[part] // 2) if stacked and spec[0] == "pp" else None
                out[f"{part}.{name}"] = (stage, dp_dim)
    return out


def _jax_shapes(maskgit_kw, critic_kw=None, patch_shape=(2, 2, 2)):
    """The scanned flax parameter shapes of a JAX MaskGit (and TokenCritic)."""
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.models.maskgit import TokenCritic as JTokenCritic

    ids = jnp.zeros((1, int(np.prod(patch_shape))), jnp.int32)
    ctx = jnp.zeros((1, 3, maskgit_kw["dim_context"]))
    out = {"maskgit": jax.eval_shape(lambda: JMaskGit(**maskgit_kw, scan_layers=True).init(
        jax.random.PRNGKey(0), ids, video_patch_shape=patch_shape, context=ctx))["params"]}
    if critic_kw is not None:
        out["critic"] = jax.eval_shape(lambda: JTokenCritic(**critic_kw, scan_layers=True).init(
            jax.random.PRNGKey(0), ids, video_patch_shape=patch_shape, context=ctx))["params"]
    return out


def test_fsdp_pipeline_placement_matches_jax(ranks4, monkeypatch):
    """Each rank's FSDP placement of every parameter of the small trainer
    against JAX's rule for a pipelined, fully sharded tree (threshold 256 on
    both sides), and each rank holds its own stage's layers alone."""
    import phenaki_tpu.parallel.mesh as jax_mesh

    monkeypatch.setattr(jax_mesh, "_FSDP_MIN_SIZE", FSDP_TEST_MIN_SIZE)
    want = _jax_fsdp_pp_specs(_jax_shapes(MASKGIT, CRITIC), {"maskgit": MASKGIT["depth"], "critic": CRITIC["depth"]})
    sharded = 0
    for r in ranks4:
        f = r["fsdp_pp"]
        for name, dim in f["placement"].items():
            stage, dp_dim = want[name]
            assert stage in (None, f["stage"]), (name, stage, f["stage"])
            assert dim == dp_dim, (name, dim, dp_dim)
            sharded += dim is not None
        assert set(f["placement"]) == {n for n, (stage, _) in want.items() if stage in (None, f["stage"])}
    assert sharded > 40  # trunk layers, embeddings and the head shard, on every rank


def test_fsdp_pipeline_placement_rule_matches_jax_at_the_flagship():
    """`fsdp.fsdp_shard_dim` as the trainer applies it on a pipeline mesh (a
    trunk layer's size counted over the whole stack) and `pipeline_stage`
    against JAX's spec for every leaf of the flagship MaskGit at fsdp 2 x pp
    2, shapes only."""
    depth = 6
    kw = dict(dim=512, num_tokens=65536, max_seq_len=1152, depth=depth, heads=8, dim_head=64, dim_context=768)
    want = _jax_fsdp_pp_specs(_jax_shapes(kw, patch_shape=(9, 16, 8)), {"maskgit": depth})
    with torch.device("meta"):
        port_shapes = {f"maskgit.{k}": v.shape for k, v in MaskGit(**kw).state_dict().items()}
    assert set(want) == set(port_shapes)
    for name, (stage, dp_dim) in want.items():
        local = name[len("maskgit."):]
        assert pipeline_stage(local, depth, 2) == stage, name
        stacked = depth if TRUNK_LAYER.match(local) else 1
        assert fsdp_shard_dim(local, port_shapes[name], None, 1, 2, stacked) == dp_dim, name
    # the stack counts: a PEG's 13,824 weights a layer shard, as JAX's stacked 82,944 do
    assert want["maskgit.transformer.layers.0.peg.weight"][1] is not None


def test_fsdp_tp_trainer_places_the_head_on_both_axes(ranks4):
    """dp 2 x tp 2 with FSDP: each rank's head holds V / 2 rows (tp) and is
    FSDP-sharded on d, JAX's P(dp on d, tp on V) for the weight; the bias's
    V / 2 rows stay whole over dp (its one dim is the tp dim); the trainer
    against one process."""
    with tempfile.TemporaryDirectory() as results:
        one = _trainer(results)
        losses = [float(one.train_step()) for _ in range(2)]
        params = _all_params(one)
    v, d = MASKGIT["num_tokens"], MASKGIT["dim"]
    for r in ranks4:
        f = r["fsdp_tp"]
        assert f["head"] == [((v // 2, d), 1), ((v // 2,), None)]
        np.testing.assert_allclose(f["losses"], losses, rtol=2e-4, atol=2e-5)
        for k, val in params.items():
            np.testing.assert_allclose(f["params"][k], val, rtol=1e-3, atol=3e-4, err_msg=k)
