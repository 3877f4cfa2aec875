"""The port's quantizers (phenaki_tpu_torch/ops/quantize.py) against the JAX
package's on bridged weights, fp32 on the CPU.

* `LFQ.forward` with 64 codes (the exact full-codebook entropy) and with
  2^14 codes (the factorized per-bit form), with and without a mask: ids
  equal wherever min |z| > 1e-4 (z, the pre-sign activations, from JAX's
  `project_in`), the quantized output within atol 1e-5, the aux loss within
  rtol 1e-5; and the gradients of the aux loss plus a product of the output
  (the straight-through path and `project_in`/`project_out`) within 1e-5 of
  JAX's.
* `VectorQuantize` on the same `vq_stats`, with and without a mask: ids
  equal, the commitment loss and the quantized output within atol 1e-5, one
  EMA update of `embed` and `cluster_size` within atol 1e-5 of JAX's
  mutable `vq_stats`, and `codebook_lookup`.
* The constructor fields at values other than their defaults, each with the
  same checks and tolerances: LFQ's `inv_temperature=10` at 64 and 2^14
  codes with `full_entropy_max_bits` below and at or above the code's bits
  (so each size runs both entropy forms), and the VQ's `decay=0.5`,
  `commitment_weight=0.25` and `eps=1e-3`.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.ops.quantize import LFQ as JLFQ  # noqa: E402
from phenaki_tpu.ops.quantize import VectorQuantize as JVQ  # noqa: E402
from phenaki_tpu_torch.bridge import flax_to_state_dict, load_flax_params
from phenaki_tpu_torch.ops.quantize import LFQ, VectorQuantize

torch.set_num_threads(1)

DIM = 32


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _inputs(seed, n=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, n, DIM).astype(np.float32)
    mask = rng.rand(2, n) > 0.3
    return x, mask


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("codebook_size", [64, 2**14], ids=["full_entropy", "factorized"])
def test_lfq_forward_matches_jax(codebook_size, masked):
    _check_lfq(codebook_size, masked)


# (codebook size, full_entropy_max_bits): 64 codes are 6 bits, 2^14 are 14
LFQ_FIELD_CASES = {"64_factorized": (64, 5), "64_full": (64, 6), "16384_full": (2**14, 14),
                   "16384_factorized": (2**14, 13)}


@pytest.mark.parametrize("case", list(LFQ_FIELD_CASES))
def test_lfq_fields_match_jax(case):
    codebook_size, max_bits = LFQ_FIELD_CASES[case]
    _check_lfq(codebook_size, True, inv_temperature=10.0, full_entropy_max_bits=max_bits)


def _check_lfq(codebook_size, masked, **fields):
    x, mask = _inputs(seed=codebook_size % 7 + masked)
    mask = mask if masked else None
    jmod = JLFQ(dim=DIM, codebook_size=codebook_size, **fields)
    variables = _numpy_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    jmask = None if mask is None else jnp.asarray(mask)
    ref_q, ref_ids, ref_aux = jmod.apply(variables, jnp.asarray(x), mask=jmask)
    mod = load_flax_params(LFQ(DIM, codebook_size, **fields), variables["params"])
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        q, ids, aux = mod(torch.from_numpy(x), mask=tmask)

    z = x @ variables["params"]["project_in"]["kernel"]
    clear = np.abs(z).min(-1) > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(ref_ids)[clear])
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5, atol=0)

    cot = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def j_loss(params, xx):
        out = jmod.apply({"params": params}, xx, mask=jmask)
        return out.aux_loss + jnp.sum(out.quantized * cot)

    g_params, g_x = jax.grad(j_loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, mask=tmask)
    (out.aux_loss + (out.quantized * torch.from_numpy(cot)).sum()).backward()
    ref = flax_to_state_dict(_numpy_tree(g_params))
    for name, p in mod.named_parameters():
        torch.testing.assert_close(p.grad, ref[name], atol=1e-5 * max(ref[name].abs().max().item(), 1.0),
                                   rtol=0, msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5, rtol=0)


def test_lfq_codes_round_trip():
    x, _ = _inputs(seed=3)
    mod = LFQ(DIM, 64)
    with torch.no_grad():
        q, ids, _ = mod(torch.from_numpy(x))
        torch.testing.assert_close(mod.indices_to_codes(ids), q, atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_vector_quantize_matches_jax(masked):
    _check_vq(masked)


def test_vector_quantize_fields_match_jax():
    _check_vq(True, decay=0.5, commitment_weight=0.25, eps=1e-3)


def _check_vq(masked, **fields):
    x, mask = _inputs(seed=5 + masked)
    mask = mask if masked else None
    jmod = JVQ(dim=DIM, codebook_size=64, **fields)
    variables = _numpy_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(x)))
    jmask = None if mask is None else jnp.asarray(mask)
    (ref_q, ref_ids, ref_aux), new_state = jmod.apply(variables, jnp.asarray(x), mask=jmask,
                                                      mutable=["vq_stats"])
    stats = variables["vq_stats"]
    mod = VectorQuantize(DIM, 64, **fields)
    load_flax_params(mod, {"embed": stats["codebook"], "cluster_size": stats["cluster_size"]})
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        frozen = mod(torch.from_numpy(x), mask=tmask, update_codebook=False)
        np.testing.assert_array_equal(mod.embed.numpy(), stats["codebook"])  # untouched
        q, ids, aux = mod(torch.from_numpy(x), mask=tmask)

    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(frozen.indices.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(ref_aux), atol=1e-5, rtol=0)
    new = _numpy_tree(new_state["vq_stats"])
    np.testing.assert_allclose(mod.embed.numpy(), new["codebook"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(mod.cluster_size.numpy(), new["cluster_size"], atol=1e-5, rtol=0)

    ref_codes = jmod.apply({"vq_stats": new}, ref_ids, method=JVQ.codebook_lookup)
    np.testing.assert_allclose(mod.codebook_lookup(ids).numpy(), np.asarray(ref_codes), atol=1e-5, rtol=0)
