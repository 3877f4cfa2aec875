"""Activation rematerialisation (`remat`) and the transformer's constructor
fields in the port, fp32 on the CPU.

* `Transformer` against the JAX package's on bridged weights (scanned
  layers), the loss within rtol 1e-6 and every gradient (the input's too)
  within 1e-5 x max|g| of its tensor (max|g| floored at 1), on
  `tests/test_ops.py:212`'s sizes and loss: with `remat=True` on both
  sides (and the port's remat output and gradients bit-equal to its own
  without), and with the fields `attn_num_null_kv=1`, `ff_mult=2` and
  `ff_inner_dim=40` at values other than their defaults;
* `MaskGit(remat=True, gradient_shrink_alpha=0.3)`: a cross-entropy loss's
  gradients against `jax.grad` of JAX's MaskGit with the same fields, each
  within 1e-4 x max|g| of its tensor (max|g| floored at 1e-4: the CPB
  output bias adds one constant a head to every score, which the softmax
  cancels, so its true gradient is 0 and both sides hold rounding noise of
  ~1e-9), and the remat gradients bit-equal to the port's own without
  remat (so alpha 0.3 holds without remat too);
* attention and FF dropout 0.3 in training mode under remat: every gradient
  bit-equal to the no-remat model's from the same global RNG state (the
  recompute replays the masks);
* `CViViT(remat=True)` in the GAN generator step (`cvivit_generator_loss`
  with the discriminator-feature perceptual term, whose adaptive weight
  takes `torch.autograd.grad(..., retain_graph=True)` before the full
  backward): the loss and every gradient bit-equal to `remat=False`'s;
* on four spawned gloo ranks, a small MaskGit's loss and gradients with
  `remat=True` bit-equal to the same model's without: pipelined at dp 2 x
  pp 2 with dropout 0.3 in training, an FSDP-wrapped pipeline stage at dp
  2 x pp 2 (its layers kept gathered through the backward), tp 2 x pp 2
  (the tp all-reduces reissued by the recompute), and dp 2 x tp 2 with FSDP
  resharding each layer after its forward.

The rank function imports no JAX: JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.models.cvivit import CViViT, Discriminator
from phenaki_tpu_torch.models.cvivit_losses import cvivit_generator_loss
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.transformer import Transformer, TransformerLayer
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.parallel import mesh as mesh_rules
from phenaki_tpu_torch.parallel.distributed import spawn_ranks
from phenaki_tpu_torch.parallel.fsdp import apply_fsdp, reshard
from phenaki_tpu_torch.parallel.mesh import make_mesh
from phenaki_tpu_torch.parallel.pipeline import pipeline_stage_module
from phenaki_tpu_torch.parallel.tp_inference import global_value, tp_local_module

torch.set_num_threads(1)

# tests/test_ops.py:212's sizes
T_DIM, T_CTX = 32, 16
FIELD_CASES = {"remat": dict(remat=True), "null_kv_1_ff_mult_2": dict(attn_num_null_kv=1, ff_mult=2),
               "ff_inner_dim_40": dict(ff_inner_dim=40)}
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=2, heads=2, dim_head=16, dim_context=16)
PATCH = (3, 2, 2)


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _transformer_inputs():
    return (np.random.RandomState(0).randn(2, 12, T_DIM).astype(np.float32),
            np.random.RandomState(1).randn(2, 5, T_CTX).astype(np.float32))


def _close(got, ref, name):
    """Within 1e-5 x max|ref| of the reference (max|ref| floored at 1)."""
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0), rtol=0, err_msg=name)


def _port_grads(module, loss_fn, *leaves):
    leaves = [torch.from_numpy(a).requires_grad_() for a in leaves]
    out = loss_fn(module, *leaves)
    out.backward()
    return out.item(), [t.grad.numpy() for t in leaves], {n: p.grad.numpy() for n, p in module.named_parameters()}


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_transformer_fields_match_jax(case):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.transformer import Transformer as JTransformer

    fields = FIELD_CASES[case]
    x, ctx = _transformer_inputs()
    cfg = dict(depth=2, dim_head=16, heads=2, has_cross_attn=True, dim_context=T_CTX)
    jt = JTransformer(dim=T_DIM, scan_layers=True, **cfg, **fields)
    variables = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x), context=jnp.asarray(ctx))

    def j_loss(params, xx):
        return jnp.sum(jt.apply({"params": params}, xx, context=jnp.asarray(ctx)) ** 2)

    ref_loss, (ref_g, ref_gx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(variables["params"],
                                                                                     jnp.asarray(x))
    params = _numpy_tree(variables["params"])

    def loss(module, xx):
        return (module(xx, context=torch.from_numpy(ctx)) ** 2).sum()

    port = load_flax_params(Transformer(T_DIM, **cfg, **fields), params)
    got_loss, (gx,), grads = _port_grads(port, loss, x)
    np.testing.assert_allclose(got_loss, float(ref_loss), rtol=1e-6)
    _close(gx, np.asarray(ref_gx), "x")
    ref = flax_to_state_dict(_numpy_tree(ref_g))
    assert sorted(ref) == sorted(grads)
    for name, g in grads.items():
        _close(g, ref[name].numpy(), name)
    if fields.get("remat"):
        plain = load_flax_params(Transformer(T_DIM, **cfg), params)
        plain_loss, (plain_gx,), plain_grads = _port_grads(plain, loss, x)
        assert plain_loss == got_loss
        np.testing.assert_array_equal(plain_gx, gx)
        for name, g in grads.items():
            np.testing.assert_array_equal(plain_grads[name], g, err_msg=name)


def _maskgit_inputs():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 65, size=(2, 12))  # 64 is the mask id
    ctx = rng.randn(2, 6, 16).astype(np.float32)
    ctx[1, 3:] = 0.0
    return ids, ctx, np.any(ctx != 0, axis=-1), rng.randint(0, 64, size=(2, 12))


def test_maskgit_remat_and_gradient_shrink_match_jax():
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.models.maskgit import MaskGit as JMaskGit
    from phenaki_tpu.utils.jit_init import jit_init

    fields = dict(remat=True, gradient_shrink_alpha=0.3)
    ids, ctx, mask, targets = _maskgit_inputs()
    jmod = JMaskGit(**MASKGIT, scan_layers=True, **fields)
    variables = jit_init(jmod, jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32), video_patch_shape=PATCH,
                         context=jnp.zeros((1, 6, 16)))

    def j_loss(params):
        logits = jmod.apply({"params": params}, jnp.asarray(ids), video_patch_shape=PATCH,
                            context=jnp.asarray(ctx), text_mask=jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(targets)[..., None], axis=-1))

    ref_loss, ref_g = jax.jit(jax.value_and_grad(j_loss))(variables["params"])
    params = _numpy_tree(variables["params"])

    def grads(**kw):
        mg = load_flax_params(MaskGit(**MASKGIT, **kw), params)
        logits = mg(torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
                    text_mask=torch.from_numpy(mask))
        loss = F.cross_entropy(logits.reshape(-1, 64), torch.from_numpy(targets).reshape(-1))
        loss.backward()
        return loss.item(), {n: p.grad.numpy() for n, p in mg.named_parameters()}

    loss, got = grads(**fields)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    ref = flax_to_state_dict(_numpy_tree(ref_g))
    assert sorted(ref) == sorted(got)
    for name, g in got.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g, r, atol=1e-4 * max(np.abs(r).max(), 1e-4), rtol=0, err_msg=name)
    plain_loss, plain = grads(**dict(fields, remat=False))
    assert plain_loss == loss
    for name, g in got.items():
        np.testing.assert_array_equal(plain[name], g, err_msg=name)


def test_remat_replays_the_dropout_masks():
    ids, ctx, mask, targets = _maskgit_inputs()

    def grads(remat):
        mg = init_parameters(MaskGit(**MASKGIT, attn_dropout=0.3, ff_dropout=0.3, remat=remat),
                             torch.Generator().manual_seed(0)).train()
        torch.manual_seed(11)
        logits = mg(torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
                    text_mask=torch.from_numpy(mask))
        F.cross_entropy(logits.reshape(-1, 64), torch.from_numpy(targets).reshape(-1)).backward()
        return logits.detach(), {n: p.grad.clone() for n, p in mg.named_parameters()}

    logits, plain = grads(False)
    remat_logits, remat = grads(True)
    assert torch.equal(logits, remat_logits)
    for name, g in plain.items():
        assert torch.equal(g, remat[name]), name
    with torch.no_grad():
        torch.manual_seed(11)
        mg = init_parameters(MaskGit(**MASKGIT, attn_dropout=0.3, ff_dropout=0.3),
                             torch.Generator().manual_seed(0)).eval()
        ref = mg(torch.from_numpy(ids), video_patch_shape=PATCH, context=torch.from_numpy(ctx),
                 text_mask=torch.from_numpy(mask))
    assert (logits - ref).abs().max() > 1e-2  # the masks did act


CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)


def test_cvivit_remat_gan_generator_step():
    video = torch.from_numpy(np.random.RandomState(8).rand(2, 3, 16, 16, 3).astype(np.float32))
    discr = init_parameters(Discriminator(dim=4, image_size=16, attn_res_layers=()),
                            torch.Generator().manual_seed(1)).requires_grad_(False)

    def step(remat):
        cv = init_parameters(CViViT(**CVIVIT, remat=remat), torch.Generator().manual_seed(0))
        loss, aux = cvivit_generator_loss(cv, video, discr=discr, perceptual_mode="disc",
                                          frame_indices=torch.tensor([1, 2]))
        loss.backward()
        return loss.item(), aux["adaptive_weight"].item(), {n: p.grad for n, p in cv.named_parameters()}

    loss, weight, plain = step(False)
    remat_loss, remat_weight, remat = step(True)
    assert remat_loss == loss and remat_weight == weight
    assert sorted(plain) == sorted(remat)
    for name, g in plain.items():
        assert g is not None and torch.equal(g, remat[name]), name


# ---------------------------------------------------------------------------
# remat on the mesh: four gloo ranks

MESH_MASKGIT = dict(MASKGIT, depth=4)  # two layers a stage at pp = 2
MESH_CASES = ("dp2_pp2_dropout", "dp2_pp2_fsdp", "tp2_pp2", "dp2_tp2_fsdp")
FSDP_TEST_MIN_SIZE = 256  # tests/test_torch_pipeline.py's: the tiny layers shard


def _mesh_batch(b=4):
    g = torch.Generator().manual_seed(3)
    return (torch.randint(0, 64, (b, 2, 2, 2), generator=g), torch.randn(b, 3, 16, generator=g),
            torch.randint(0, 64, (b, 8), generator=g))


def _mesh_case(case, remat):
    """This rank's loss and its parameters' gradients (tp and FSDP shards
    gathered) for one mesh case."""
    dropout = 0.3 if case.endswith("dropout") else 0.0
    mg = init_parameters(MaskGit(**MESH_MASKGIT, remat=remat, attn_dropout=dropout, ff_dropout=dropout),
                         torch.Generator().manual_seed(1))
    shapes = {k: v.shape for k, v in mg.state_dict().items()}
    pipelined = "pp2" in case
    mesh = make_mesh(dp=2, pp=2) if case.startswith("dp2_pp2") else (
        make_mesh(tp=2, pp=2) if case == "tp2_pp2" else make_mesh(dp=2, tp=2))
    local = pipeline_stage_module(mg, mesh) if pipelined else tp_local_module(mg, mesh.tp, mesh.tp_group)
    if case.endswith("fsdp"):
        apply_fsdp(local, mesh, (TransformerLayer,))
    local.train(dropout > 0)
    ids, ctx, targets = _mesh_batch()
    rows = ids.shape[0] // mesh.data_size
    sl = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    kw = dict(pipeline_mesh=mesh, pipeline_microbatches=2, generator=torch.Generator().manual_seed(5)) \
        if pipelined else {}
    logits = local(ids[sl], context=ctx[sl], **kw)
    loss = F.cross_entropy(logits.reshape(-1, 64), targets[sl].reshape(-1))
    loss.backward()
    if case.endswith("fsdp") and pipelined:
        reshard(local, (TransformerLayer,))
    grads = {n: global_value(n, p.grad, mesh, shapes[n]).numpy() for n, p in local.named_parameters()}
    torch.distributed.barrier()
    return dict(loss=loss.item(), grads=grads)


def _rank4(rank, world):
    torch.set_num_threads(1)
    mesh_rules.FSDP_MIN_SIZE = FSDP_TEST_MIN_SIZE
    return {case: {remat: _mesh_case(case, remat) for remat in (False, True)} for case in MESH_CASES}


@pytest.fixture(scope="module")
def ranks4():
    return spawn_ranks(_rank4, 4, timeout=300)


@pytest.mark.parametrize("case", MESH_CASES)
def test_remat_on_the_mesh_matches_no_remat(ranks4, case):
    for r in ranks4:
        plain, remat = r[case][False], r[case][True]
        assert np.isfinite(plain["loss"]) and remat["loss"] == plain["loss"]
        assert sorted(plain["grads"]) == sorted(remat["grads"]) and plain["grads"]
        for name, g in plain["grads"].items():
            np.testing.assert_array_equal(remat["grads"][name], g, err_msg=f"{case} {name}")
