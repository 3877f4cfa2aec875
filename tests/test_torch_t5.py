"""The port's T5 encoder stack (phenaki_tpu_torch/text/t5_torch.py) against
the JAX package's (phenaki_tpu/text/t5_jax.py) and HuggingFace's, f32 on
the CPU:

* `T5EncoderStack` with random flax weights (`t5_jax.T5EncoderStack.init`
  from a seed) bridged by `bridge.load_t5_params`, gated-GELU and ReLU,
  within atol 1e-5 of JAX's on a ragged batch;
* against HF's `T5EncoderModel` with random weights through the port's
  `convert_hf_state_dict` within atol 1e-4, and both conversions land the
  same tensors;
* `relative_position_bucket` equal to JAX's;
* the output contract: padded positions exactly zero, the mask recovered
  as `any(embed != 0, -1)`, and a padded row's valid positions equal to
  the same row encoded alone;
* `TorchT5Encoder` and `get_text_encoder` on a tiny checkpoint saved to a
  temporary directory: the stack is the first backend, within 1e-5 of
  JAX's stack loaded by `t5_jax.load_hf_t5` on the same ids and within
  1e-4 of HF's encoder.
"""

import numpy as np
import pytest
import torch

from phenaki_tpu_torch.bridge import load_t5_params
from phenaki_tpu_torch.text import t5
from phenaki_tpu_torch.text.t5_torch import (
    T5EncoderConfig,
    T5EncoderStack,
    TorchT5Encoder,
    convert_hf_state_dict,
    relative_position_bucket,
)

TINY = dict(vocab_size=100, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)


def _ids_and_mask():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab_size"], size=(3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[0, 6:] = 0
    mask[1, 2:] = 0
    return ids, mask


def _port(cfg, sd=None):
    stack = T5EncoderStack(cfg).eval()
    if sd is not None:
        stack.load_state_dict(sd)
    return stack


def _encode(stack, ids, mask):
    with torch.no_grad():
        return stack(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("gated", [True, False])
def test_stack_matches_jax_with_random_flax_weights(gated):
    import jax
    import jax.numpy as jnp

    from phenaki_tpu.text import t5_jax

    jcfg = t5_jax.T5EncoderConfig(**TINY, gated_act=gated)
    ids, mask = _ids_and_mask()
    jstack = t5_jax.T5EncoderStack(jcfg)
    variables = jstack.init(jax.random.PRNGKey(1), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    want = np.asarray(jstack.apply(variables, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))

    stack = load_t5_params(_port(T5EncoderConfig(**TINY, gated_act=gated)), jax.device_get(variables))
    got = _encode(stack, ids, mask)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _hf_model(gated):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(**TINY, relative_attention_num_buckets=32, relative_attention_max_distance=128,
                                   feed_forward_proj="gated-gelu" if gated else "relu", dropout_rate=0.0)
    torch.manual_seed(0)
    return transformers.T5EncoderModel(hf_cfg).eval(), hf_cfg


@pytest.mark.parametrize("gated", [True, False])
def test_stack_matches_hf_with_random_weights(gated):
    model, hf_cfg = _hf_model(gated)
    cfg = T5EncoderConfig.from_hf(hf_cfg)
    assert cfg.gated_act == gated and cfg.num_layers == TINY["num_layers"]
    ids, mask = _ids_and_mask()
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
    want = want.numpy() * mask[..., None]  # the reference's contract zeroes padding
    got = _encode(_port(cfg, convert_hf_state_dict(model.state_dict(), cfg)), ids, mask)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_hf_conversion_lands_where_the_jax_conversion_does():
    import jax

    from phenaki_tpu.text import t5_jax

    model, hf_cfg = _hf_model(True)
    cfg = T5EncoderConfig.from_hf(hf_cfg)
    ours = convert_hf_state_dict(model.state_dict(), cfg)
    via_jax = load_t5_params(_port(cfg), jax.device_get(
        t5_jax.convert_hf_state_dict(model.state_dict(), t5_jax.T5EncoderConfig.from_hf(hf_cfg)))).state_dict()
    assert ours.keys() == via_jax.keys()
    for k, v in ours.items():
        assert torch.equal(v, via_jax[k]), k


def test_bucket_function_matches_jax():
    from phenaki_tpu.text.t5_jax import relative_position_bucket as jax_bucket

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    for buckets, distance in ((32, 128), (16, 64), (32, 32)):
        np.testing.assert_array_equal(relative_position_bucket(rel, buckets, distance),
                                      jax_bucket(rel, buckets, distance))


def test_output_contract_mask_recoverable():
    torch.manual_seed(2)
    stack = _port(T5EncoderConfig(**TINY))
    ids, mask = _ids_and_mask()
    out = _encode(stack, ids, mask)
    assert out.shape == (3, 9, TINY["d_model"]) and out.dtype == np.float32
    assert np.all(out[mask == 0] == 0)
    np.testing.assert_array_equal(np.any(out != 0, axis=-1), mask.astype(bool))
    alone = _encode(stack, ids[1:2, :2], mask[1:2, :2])  # row 1 holds 2 valid tokens
    np.testing.assert_allclose(out[1, :2], alone[0], atol=1e-6)


def _tiny_checkpoint(path):
    transformers = pytest.importorskip("transformers")
    from test_torch_text import _write_tiny_spiece

    torch.manual_seed(0)
    config = transformers.T5Config(vocab_size=128, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2,
                                   feed_forward_proj="gated-gelu")
    transformers.T5EncoderModel(config).save_pretrained(str(path))
    _write_tiny_spiece(path / "spiece.model")


def test_torch_t5_encoder_is_the_first_backend_and_matches_jax(tmp_path):
    import jax.numpy as jnp

    from phenaki_tpu.text import t5_jax

    _tiny_checkpoint(tmp_path)
    texts = ["the cat", "cathe the att cat"]
    encoder = t5.get_text_encoder(str(tmp_path), device="cpu")
    assert isinstance(encoder, TorchT5Encoder)
    assert {p.device.type for p in encoder.model.parameters()} == {"cpu"}
    ours = encoder(texts)
    # JAX's stack on the same checkpoint and token ids (its module applied
    # as it is: `JaxT5Encoder` jits the bucket lookup, which this JAX refuses)
    module, variables, _ = t5_jax.load_hf_t5(str(tmp_path))
    enc = encoder.tokenizer(texts, return_tensors="np", padding="longest", max_length=256, truncation=True)
    want = module.apply(variables, jnp.asarray(enc["input_ids"], jnp.int32),
                        jnp.asarray(enc["attention_mask"], jnp.int32))
    np.testing.assert_allclose(ours, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, t5._HFT5Encoder(str(tmp_path))(texts), atol=1e-4, rtol=0)
    mask = np.any(ours != 0, axis=-1)
    assert mask[0].sum() < mask[1].sum()
    on_meta = TorchT5Encoder(str(tmp_path), device="meta")
    assert {p.device.type for p in on_meta.model.parameters()} == {"meta"}
